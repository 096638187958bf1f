"""tools/vlint_torch, the port's checker: every check flags exactly its
seeded lines in its bad fixture and nothing in its good one; each
generic check flags the same lines as tools/vlint does on the
reference's fixture; the home modules pass only by their allowance; the
scopes leave other modules alone; the kernel checks catch a broken copy
of each of the port's own wrappers; and the suppression contract holds
(a reason suppresses, none reports VL00 and keeps the finding)."""

import os
import shutil
import subprocess
import sys

import pytest

from tools.vlint import run_paths as ref_run_paths
from tools.vlint_torch import run_paths
from tools.vlint_torch.config import DEFAULT_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "vlint_torch_fixtures")
REF_FIX = os.path.join(REPO, "tests", "vlint_fixtures")
PKG = os.path.join(REPO, "veneur_tpu_torch")


def lint(*names, config=None):
    vs = run_paths([os.path.join(FIX, n) for n in names], config)
    return [(v.rule, v.line) for v in vs]


BAD = {
    "th01_bad.py": [("TH01", 19)],
    # a thread started through a spawner method (the port's _spawn)
    "th01_spawn_bad.py": [("TH01", 31)],
    "cf01_bad.py": [("CF01", 21)],
    "rs01_bad.py": [("RS01", 9), ("RS01", 14)],
    "sr02_bad.py": [("SR02", 9), ("SR02", 20), ("SR02", 34), ("SR02", 38)],
    "dr01_bad.py": [("DR01", 10), ("DR01", 15), ("DR01", 16), ("DR01", 21),
                    ("DR01", 44)],
    "dr02_bad.py": [("DR02", 9), ("DR02", 13)],
    "tl01_bad.py": [("TL01", 13), ("TL01", 17), ("TL01", 21),
                    ("TL01", 22)],
    "tr01_bad.py": [("TR01", 7), ("TR01", 11), ("TR01", 16), ("TR01", 20)],
    "wc01_bad.py": [("WC01", 15), ("WC01", 19), ("WC01", 23)],
    "ov01_bad.py": [("OV01", 12), ("OV01", 21), ("OV01", 39)],
    "sk01_bad.py": [("SK01", 5), ("SK01", 7), ("SK01", 9), ("SK01", 15),
                    ("SK01", 19)],
    "ds01_bad.py": [("DS01", 11), ("DS01", 29), ("DS01", 34)],
    "qt01_bad.py": [("QT01", 10), ("QT01", 14), ("QT01", 21), ("QT01", 24),
                    ("QT01", 24)],
    # the imports of triton and cpp_extension, the variants path, the
    # inline build, the library load, the C-entry launch and the Triton
    # launch; the suppressed load and ctypes' types stay silent
    "hk01_bad.py": [("HK01", 7), ("HK01", 8), ("HK01", 13), ("HK01", 22),
                    ("HK01", 26), ("HK01", 30), ("HK01", 35)],
    "hk01_bad.cu": [("HK01", 1)],
    # no plain branch, an inline expression for a plain version, a launch
    # left uncounted, a count on the plain branch, a count with no
    # launch, an uncounted Triton launch; the suppressed one is silent
    "hk02_bad.py": [("HK02", 13), ("HK02", 20), ("HK02", 33), ("HK02", 39),
                    ("HK02", 48), ("HK02", 60)],
    # a wrapper call, a build, a C entry and a method reaching the probe
    # with swallowing handlers; the re-raising handler, the unrelated
    # swallow and the suppressed one are silent
    "hk03_bad.py": [("HK03", 17), ("HK03", 24), ("HK03", 32),
                    ("HK03", 69)],
}

GOOD = ["th01_good.py", "cf01_good.py", "rs01_good.py", "sr02_good.py",
        "dr01_good.py", "dr02_good.py", "tl01_good.py", "tr01_good.py",
        "wc01_good.py", "ov01_good.py", "sk01_good.py", "ds01_good.py",
        "qt01_good.py", "hk01_good.py", "hk01_kernels_good.py",
        "hk02_good.py", "hk03_good.py"]

# each generic check's fixture in the reference's directory
REF = {"TH01": "server.py", "CF01": "cf01_bad.py", "RS01": "rs01_bad.py",
       "SR02": "sr02_bad.py", "DR01": "dr01_bad.py", "DR02": "dr02_bad.py",
       "TL01": "tl01_bad.py", "TR01": "tr01_bad.py", "WC01": "wc01_bad.py",
       "OV01": "ov01_bad.py", "SK01": "sk01_bad.py", "DS01": "ds01_bad.py",
       "QT01": "qt01_bad.py"}


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_fixture_raises_exactly_its_code(name):
    assert lint(name) == BAD[name]


@pytest.mark.parametrize("name", GOOD)
def test_good_fixture_raises_nothing(name):
    assert lint(name) == []


def test_every_check_has_a_bad_and_a_good_fixture():
    codes = set(DEFAULT_CONFIG["scope"])
    assert {n[:4].upper() for n in BAD} == codes
    assert {n[:4].upper() for n in GOOD} == codes


@pytest.mark.parametrize("code", sorted(REF))
def test_flags_the_lines_the_reference_checker_flags(code):
    """The port's copy of the reference's fixture is flagged on exactly
    the lines tools/vlint flags on the original; where the port's scope
    takes the original in (its /<code>_ marker), so is the original."""
    ref_path = os.path.join(REF_FIX, REF[code])
    ref = [v.line for v in ref_run_paths([ref_path]) if v.rule == code]
    port = [v.line for v in run_paths([os.path.join(
        FIX, f"{code.lower()}_bad.py")]) if v.rule == code]
    assert ref and port == ref
    if any(s in ref_path for s in DEFAULT_CONFIG["scope"][code]):
        assert [v.line for v in run_paths([ref_path])
                if v.rule == code] == ref


def test_config_key_without_a_consumer():
    # dead_key is read only by the config module's own validation;
    # flush_timeout reaches cf01_good.py through its property
    assert lint("cf01_config_bad.py", "cf01_good.py") == [("CF01", 13)]


# (code, home module): the module holds what the check flags and passes
# only through the check's allowance
HOMES = [("RS01", "resilience.py"), ("SR02", "ops/tdigest.py"),
         ("SR02", "sketches/req.py"), ("DR01", "durability/journal.py"),
         ("DR02", "durability/records.py"), ("TL01", "observe/registry.py"),
         ("TR01", "cluster/wire.py"), ("WC01", "cluster/wire.py"),
         ("SK01", "sketches/ull.py"), ("SK01", "ops/hll.py"),
         ("SK01", "kernels/compress.py"), ("SK01", "parallel/mesh.py"),
         ("HK01", "kernels/_build.py")]


@pytest.mark.parametrize("code,rel", HOMES)
def test_home_module_passes_only_by_its_allowance(code, rel):
    path = os.path.join(PKG, *rel.split("/"))
    assert [v for v in run_paths([path]) if v.rule == code] == []
    cfg = {"allow": {k: v for k, v in DEFAULT_CONFIG["allow"].items()
                     if k != code}}
    if code == "HK01":
        cfg["hk01_homes"] = ()
    assert [v for v in run_paths([path], cfg) if v.rule == code]


# (code, module outside the check's scope that holds what it flags)
OUT_OF_SCOPE = [("TH01", "models/pipeline.py"), ("TH01", "ingest/native.py"),
                ("DR01", "sinks/basic.py"), ("DR02", "ingest/native.py"),
                ("DR02", "sketches/__init__.py"),
                ("QT01", "models/pipeline.py")]


@pytest.mark.parametrize("code,rel", OUT_OF_SCOPE)
def test_scope_leaves_other_modules_alone(code, rel):
    path = os.path.join(PKG, *rel.split("/"))
    assert [v for v in run_paths([path]) if v.rule == code] == []
    scope = dict(DEFAULT_CONFIG["scope"])
    scope[code] = ("veneur_tpu_torch/",)
    assert [v for v in run_paths([path], {"scope": scope})
            if v.rule == code]


def _copy_into_pkg(tmp_path, rel, edit=None):
    """Copy veneur_tpu_torch/<rel> to the same place under tmp_path,
    through `edit(text)`; returns the copy's path."""
    src = os.path.join(PKG, *rel.split("/"))
    dst = tmp_path / "veneur_tpu_torch" / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    with open(src) as f:
        text = f.read()
    dst.write_text(edit(text) if edit else text)
    return str(dst)


# the port's launching wrappers and the count each adds to
WRAPPERS = [("kernels/compress.py", "compress"),
            ("kernels/hll_stats.py", "hll_stats"),
            ("kernels/ull_insert.py", "ull_insert"),
            ("kernels/probe.py", "probe")]


@pytest.mark.parametrize("rel,name", WRAPPERS)
def test_wrapper_without_its_count_is_flagged(tmp_path, rel, name):
    call = f'    count_launch("{name}")\n'
    path = _copy_into_pkg(tmp_path, rel)
    assert run_paths([path]) == []
    path = _copy_into_pkg(tmp_path, rel, lambda t: t.replace(call, ""))
    vs = run_paths([path])
    assert [v.rule for v in vs] == ["HK02"]
    assert "without count_launch" in vs[0].message


@pytest.mark.parametrize("rel,name", WRAPPERS)
def test_wrapper_without_its_plain_version_is_flagged(tmp_path, rel, name):
    path = _copy_into_pkg(tmp_path, rel,
                          lambda t: t.replace(".is_cpu:", ".is_meta:"))
    vs = run_paths([path])
    assert [v.rule for v in vs] == ["HK02"]
    assert "no plain version" in vs[0].message


def test_kernel_source_outside_csrc_is_flagged(tmp_path):
    src = os.path.join(PKG, "variants", "ull_insert_fold.cu")
    for rel, want in (("variants", []), ("csrc", []),
                      ("ops", [("HK01", 1)])):
        d = tmp_path / "veneur_tpu_torch" / rel
        d.mkdir(parents=True)
        shutil.copy(src, d / "ull_insert_fold.cu")
        vs = run_paths([str(d / "ull_insert_fold.cu")])
        assert [(v.rule, v.line) for v in vs] == want


def _tree_copy(tmp_path):
    dst = tmp_path / "veneur_tpu_torch"
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    return dst


def test_config_key_dropped_from_its_consumers_is_flagged(tmp_path):
    tree = _tree_copy(tmp_path)
    cfg = tree / "config.py"
    text = cfg.read_text()
    # flush_timeout reaches the server only through this property
    assert text.count("def flush_timeout_seconds(") == 1
    cfg.write_text(text.replace("def flush_timeout_seconds(",
                                "def unread_seconds("))
    lines = cfg.read_text().splitlines()
    line = next(i for i, t in enumerate(lines, start=1)
                if t.strip().startswith("flush_timeout:"))
    assert [(v.rule, v.path.rsplit("/", 1)[-1], v.line)
            for v in run_paths([str(tree)])] == [("CF01", "config.py", line)]


def test_config_key_added_without_a_consumer_is_flagged(tmp_path):
    tree = _tree_copy(tmp_path)
    cfg = tree / "config.py"
    text = cfg.read_text()
    anchor = "    retry_max_attempts: int = 3\n"
    assert text.count(anchor) == 1
    cfg.write_text(text.replace(anchor, anchor
                                + "    unplumbed_knob: int = 0\n"))
    line = cfg.read_text().splitlines().index("    unplumbed_knob: int = 0")
    assert [(v.rule, v.line) for v in run_paths([str(tree)])] == [
        ("CF01", line + 1)]


def _suppressed_files():
    out = []
    for root, dirs, files in os.walk(PKG):
        dirs[:] = sorted(d for d in dirs if d not in ("_build",
                                                      "__pycache__"))
        for f in sorted(files):
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if "# vlint: disable=" in fh.read():
                        out.append(os.path.relpath(
                            os.path.join(root, f), PKG).replace(os.sep, "/"))
    return out


@pytest.mark.parametrize("rel", _suppressed_files())
def test_every_suppression_in_the_port_is_load_bearing(tmp_path, rel):
    """Stripping a module's suppressions brings back exactly the
    findings they name: none is stale, and each names its rule."""
    named = []

    def strip(text):
        kept = []
        for line in text.splitlines(keepends=True):
            if line.strip().startswith("# vlint: disable="):
                rules = line.split("disable=", 1)[1].split()[0]
                named.extend(rules.split(","))
                continue
            kept.append(line)
        return "".join(kept)

    path = _copy_into_pkg(tmp_path, rel, strip)
    assert named
    assert sorted(v.rule for v in run_paths([path])) == sorted(named)


def test_suppression_needs_a_reason():
    # the documented egress on line 8 is suppressed; the reasonless
    # disable on line 12 suppresses nothing and is itself VL00
    assert lint("rs01_suppressed.py") == [("RS01", 12), ("VL00", 12)]


def test_unparsable_file_is_reported(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    assert [(v.rule, v.line) for v in run_paths([str(bad)])] == [
        ("VL01", 1)]


def test_violation_str_is_clickable():
    path = os.path.join(FIX, "rs01_bad.py")
    vs = run_paths([path])
    assert str(vs[0]).startswith(path.replace(os.sep, "/") + ":9: RS01 ")


def test_cli_exits_one_with_findings_and_two_on_a_missing_path():
    proc = subprocess.run(
        [sys.executable, "-m", "tools.vlint_torch",
         os.path.join(FIX, "rs01_bad.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "rs01_bad.py:9: RS01" in proc.stdout
    assert "vlint: 2 violations in 1 path(s)" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "tools.vlint_torch", "no_such_dir"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
