"""The port's daemon CLI: `--validate-config`, and a real run in a
subprocess on the CPU (`aggregation_backend: cpu`) that takes DogStatsD
over UDP, writes its intervals to a `flush_file` as the reference's
LocalFilePlugin writes the same rows, and exits 0 on SIGTERM."""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

from veneur_tpu.metrics import InterMetric, MetricType
from veneur_tpu.sinks.basic import LocalFilePlugin
from veneur_tpu_torch.cli import veneur as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(tmp_path, port):
    path = tmp_path / "veneur.yaml"
    path.write_text(f"""
interval: "1s"
hostname: clihost
statsd_listen_addresses: ["udp://127.0.0.1:{port}"]
flush_file: "{tmp_path / 'flush.tsv'}"
aggregation_backend: cpu
percentiles: [0.5, 0.99]
tpu_histogram_slots: 256
tpu_counter_slots: 128
tpu_gauge_slots: 128
tpu_set_slots: 64
tpu_batch_size: 256
""")
    return str(path)


def test_validate_config_prints_config_ok(tmp_path, capsys):
    assert cli.main(["-f", _config(tmp_path, 8126),
                     "--validate-config"]) == 0
    assert capsys.readouterr().out.strip() == "config ok"


def _metric(row: str) -> InterMetric:
    """One TSV row back into the reference's InterMetric (an int value
    stays an int, as the registry's counters are)."""
    name, tags, mtype, host, ts, value, _ = row.rstrip("\n").split("\t")
    v = int(value) if value.lstrip("-").isdigit() else float(value)
    return InterMetric(name=name, timestamp=int(ts), value=v,
                       tags=tags.split(",") if tags else [],
                       type=MetricType[mtype.upper()], hostname=host)


def test_cli_run_writes_the_references_tsv_and_exits_0_on_sigterm(
        tmp_path):
    port = _free_udp_port()
    cfg = _config(tmp_path, port)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "veneur_tpu_torch.cli.veneur", "-f", cfg],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    log = []
    serving = threading.Event()

    def read_stderr():
        for line in proc.stderr:
            log.append(line)
            if "serving on cpu" in line:
                serving.set()

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    flush = tmp_path / "flush.tsv"
    try:
        assert serving.wait(120), "".join(log)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.sendto(b"cli.count:3|c\ncli.count:4|c|@0.5\ncli.lat:12|ms\n"
                     b"cli.lat:30|ms\ncli.temp:7.5|g\ncli.users:a|s",
                     ("127.0.0.1", port))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if flush.exists() and "cli.lat.count" in flush.read_text():
                break
            time.sleep(0.05)
        text = flush.read_text()
        assert "cli.lat.count" in text, "".join(log)
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
        reader.join(10)
    assert rc == 0, "".join(log)
    rows = [ln for ln in flush.read_text().splitlines(keepends=True)]
    ref = tmp_path / "ref.tsv"
    LocalFilePlugin(str(ref), interval_s=1).flush(
        [_metric(r) for r in rows], "")
    assert ref.read_text() == "".join(rows)
    ms = [_metric(r) for r in rows]
    assert sum(m.value for m in ms if m.name == "cli.count") == 11.0
    assert [m.value for m in ms if m.name == "cli.lat.max"] == [30.0]
    assert [m.value for m in ms if m.name == "cli.temp"] == [7.5]
    assert all(m.hostname == "clihost" for m in ms)
