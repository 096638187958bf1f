"""The port's config against the reference's: the same YAML or
environment gives field-for-field the same Config, and the same invalid
config is refused by both packages with the same error."""

import ast
import dataclasses
import os

import pytest

from veneur_tpu import config as jconfig
from veneur_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _test_server_texts():
    """Every YAML text tests/test_server.py hands to read_config or keeps
    in a `text` variable."""
    tree = ast.parse(open(os.path.join(ROOT, "tests", "test_server.py"))
                     .read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "read_config":
            for kw in node.keywords:
                if kw.arg == "text" and isinstance(kw.value, ast.Constant):
                    out.append(kw.value.value)
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "text" for t in node.targets) \
                and isinstance(node.value, ast.Constant):
            out.append(node.value.value)
    return out


def _both(**kw):
    """(reference result, port result); an exception stands for itself
    as (type name, message)."""
    out = []
    for mod in (jconfig, tconfig):
        try:
            out.append(dataclasses.asdict(mod.read_config(**kw)))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    return out


def test_fields_and_defaults_are_the_references():
    assert [(f.name, f.default, f.type) for f in dataclasses.fields(
        tconfig.Config) if f.default is not dataclasses.MISSING] == [
        (f.name, f.default, f.type) for f in dataclasses.fields(
            jconfig.Config) if f.default is not dataclasses.MISSING]
    assert dataclasses.asdict(tconfig.Config()) == \
        dataclasses.asdict(jconfig.Config())


def test_example_yaml_reads_the_same():
    j, t = _both(path=os.path.join(ROOT, "example.yaml"), env={})
    assert isinstance(t, dict) and t == j


def test_test_server_texts_read_the_same():
    texts = _test_server_texts()
    valid = 0
    for text in texts:
        j, t = _both(text=text, env={})
        assert t == j, text
        valid += isinstance(t, dict)
    assert len(texts) >= 10 and valid >= 4


def test_env_overrides_read_the_same():
    env = {"VENEUR_INTERVAL": "2s", "VENEUR_PERCENTILES": "0.5, 0.9",
           "VENEUR_NUM_WORKERS": "3", "VENEUR_DEBUG": "yes",
           "VENEUR_TAGS": "a:b,c:d", "VENEUR_TPU_COMPRESSION": "50",
           "VENEUR_STATSD_LISTEN_ADDRESSES": "udp://127.0.0.1:0",
           "VENEUR_AGGREGATION_BACKEND": "cpu", "VENEUR_UNKNOWN": "1"}
    j, t = _both(text="interval: 10s\nhostname: h\n", env=env)
    assert isinstance(t, dict) and t == j
    assert t["num_workers"] == 3 and t["percentiles"] == [0.5, 0.9]
    assert t["debug"] is True and t["interval"] == "2s"


@pytest.mark.parametrize("text", [
    "percentiles: [1.5]",
    "percentiles: [0]",
    "interval: 0s",
    "tpu_buffer_depth: 2",
    "tpu_hll_precision: 31",
    "stats_address: localhost",
    "stats_address: 'host:notaport'",
    "durability_fsync: sometimes",
    "history_retention_generations: 2",
    "flight_recorder_max_phases: 4",
    "overload_sketch_buckets: 100",
    "histogram_backend: ddsketch",
    "set_backend: cpc",
    "tpu_flush_fetch: eventually",
    "tpu_fused_kernels: maybe",
    "tpu_flush_incremental_threshold: 0",
    "retry_max_attempts: 0",
    "forward_centroid_codec: zstd",
    "metric_max_name_length: 4",
    "tpu_req_capacity: 30",
])
def test_invalid_configs_are_refused_by_both(text):
    j, t = _both(text=text, env={})
    assert isinstance(j, tuple) and j[0] == "ValueError", j
    assert t == j


def test_read_config_without_yaml_text_needs_no_yaml():
    """env alone parses no YAML (the module imports none either)."""
    cfg = tconfig.read_config(env={"VENEUR_INTERVAL": "5s"})
    assert cfg.interval_seconds == 5.0
