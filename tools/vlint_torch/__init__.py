"""vlint_torch: the project's static checker over the PyTorch/CUDA port.

The generic checks of tools/vlint (TH01, CF01, RS01, SR02, DR01, DR02,
TL01, TR01, WC01, OV01, SK01, DS01, QT01), retargeted at
veneur_tpu_torch/, and the kernel checks of the port (HK01-HK03, the
twin of PK01 for hand-written Hopper kernels). Suppression syntax,
violation type and parsing are tools/vlint's (core.py), used read-only;
see tools/vlint_torch/README.md.

Run: `python -m tools.vlint_torch veneur_tpu_torch`
"""

from __future__ import annotations

import os

from ..vlint.core import (Violation, apply_suppressions,  # noqa: F401
                          load_project)
from .checks import CHECKS, build_context
from .config import DEFAULT_CONFIG
from .kernel_checks import PY_CHECKS, check_hk01_native

__all__ = ["Violation", "run_paths"]

# the sources a run reads: Python, the kernel sources, and C/C++ (for a
# `__global__` outside csrc/)
_EXT = (".py", ".cu", ".cuh", ".cpp", ".cc", ".cxx", ".h", ".hpp")
_SKIP_DIRS = ("__pycache__", "_build", ".git")


def discover(paths: list) -> list:
    """Expand files and directories into a sorted list of lintable
    files."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(os.path.normpath(p)):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(_EXT))
        elif os.path.isfile(p):
            out.append(os.path.normpath(p))
        else:
            raise FileNotFoundError(p)
    return out


def run_paths(paths: list, config: dict | None = None) -> list:
    """Lint files and directories; returns the violations sorted by path,
    line and rule."""
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    proj = load_project(discover(paths))
    ctx = build_context(proj, cfg)
    checks = {**CHECKS, **PY_CHECKS}
    out = list(proj.errors)
    for mod in proj.py_modules:
        found = []
        for code, check in checks.items():
            if not any(s in mod.path for s in cfg["scope"][code]):
                continue
            if any(a in mod.path for a in cfg["allow"].get(code, ())):
                continue
            found.extend(check(mod, ctx, cfg))
        out.extend(apply_suppressions(mod.path, mod.lines, found))
    for nf in proj.native_files:
        if any(s in nf.path for s in cfg["scope"]["HK01"]):
            out.extend(apply_suppressions(nf.path, nf.lines,
                                          check_hk01_native(nf, cfg)))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))
