"""The port's kernel layer on the CPU: the probe's plain version, the C
entry table against the CUDA sources, and the build step (with a
stand-in compiler, since there is no nvcc here).

The kernels themselves run only on the card: chip_smoke.py builds each
one and holds it against its plain version there.
"""

import os
import re
import stat
import sys
import threading

import pytest
import torch

from veneur_tpu.kernels import probe_interpret
from veneur_tpu_torch import kernels
from veneur_tpu_torch.kernels import _build, probe


def test_probe_on_cpu_runs_plain_and_counts_nothing():
    kernels.reset_launches()
    assert probe.probe("cpu")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert torch.equal(probe.probe_add(x), x + 1)
    assert all(n == 0 for n in kernels.launches.values())


def test_count_launch_loses_no_count_under_threads():
    """8 threads x 10000 calls, with a short switch interval so that the
    threads interleave inside the increment: every call is counted."""
    kernels.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(
            target=lambda: [kernels.count_launch("compress")
                            for _ in range(10000)]) for _ in range(8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
        assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(old)
    assert kernels.launches["compress"] == 80000
    kernels.reset_launches()
    assert all(n == 0 for n in kernels.launches.values())


def test_probe_agrees_with_the_jax_probe():
    """The JAX probe (x + 1 under Pallas interpret mode) and the port's
    probe give the same verdict here."""
    assert probe_interpret() is True
    assert probe.probe("cpu") is True


def test_every_entry_is_defined_with_its_arity():
    text = "".join(open(p).read() for p in _build.sources())
    for name, fmt in _build.ENTRIES.items():
        m = re.search(rf"\b(?:int|size_t)\s+{name}\s*\(([^)]*)\)", text)
        assert m, f"{name} is not defined in csrc/"
        assert len(m.group(1).split(",")) == len(fmt), name


def test_every_entry_is_bound_with_its_format():
    """csrc/bindings.cpp converts each entry's arguments by the format
    that ENTRIES lists, and exports it under the entry's name."""
    text = open(_build.BINDINGS).read()
    for name, fmt in _build.ENTRIES.items():
        assert f'parse("{name}", "{fmt}",' in text, name
        assert f'{{"{name}", FASTCALL(' in text, name
    assert text.count("FASTCALL(py_") == len(_build.ENTRIES)


def test_every_counted_kernel_has_a_source():
    names = {os.path.basename(p)[:-3] for p in _build.sources()}
    assert set(kernels.launches) == names


_FAKE_NVCC = """#!/bin/sh
# stand-in compiler: logs its arguments, writes its -o file, and fails
# on a source named in FAIL_ON
echo "$@" >> "{log}"
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  case "$a" in *"$FAIL_ON"*) if [ -n "$FAIL_ON" ]; then exit 1; fi;; esac
  prev="$a"
done
echo built > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return log


def test_build_compiles_each_source_then_links(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAIL_ON", "")
    path, _secs, _log = _build.build()
    assert os.path.isfile(path)
    calls = fake_nvcc.read_text().splitlines()
    srcs = _build.sources() + [_build.BINDINGS]
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(compiles) == len(srcs) == len(calls) - 1
    assert sorted(c.split()[-1] for c in compiles) == sorted(srcs)
    link = calls[-1].split()
    assert "-shared" in link
    assert sum(a.endswith((".cu.o", ".cpp.o")) for a in link) == len(srcs)
    # an unchanged tree is not built again
    assert _build.build()[1] == 0.0
    assert len(fake_nvcc.read_text().splitlines()) == len(calls)


def test_build_fails_loudly_when_a_source_does_not_compile(fake_nvcc,
                                                          monkeypatch):
    monkeypatch.setenv("FAIL_ON", "ull_insert.cu")
    with pytest.raises(_build.NvccError):
        _build.build()
    assert not os.path.exists(_build.library_path())


def test_compress_clock_stamps_follow_the_kernel_source():
    """compress_clocks.py stamps the row start and every barrier that
    stands on its own line of csrc/compress.cu, and refuses a source
    that has lost its anchors (it runs only on the card)."""
    import compress_clocks
    src = open(os.path.join(_build.CSRC_DIR, "compress.cu")).read()
    out = compress_clocks.instrumented_source(src)
    bare = sum(line.strip() == "__syncthreads();"
               for line in src.splitlines())
    assert bare > 10
    assert out.count("vt_clk[row * ") == bare + 1
    assert out.count("__syncthreads();") == src.count("__syncthreads();")
    with pytest.raises(RuntimeError):
        compress_clocks.instrumented_source(
            src.replace('#include "device_guard.cuh"', ""))
