"""Tier-1 gate: the port must be clean under its checker.

Runs the analyzer as documented — `python -m tools.vlint_torch
veneur_tpu_torch` — and requires exit 0. Any new violation either gets
fixed or carries an inline `# vlint: disable=XXnn reason=...` explaining
why it is intentional; see tools/vlint_torch/README.md.
"""

import os
import subprocess
import sys

from tools.vlint_torch import run_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_is_vlint_clean_api():
    vs = run_paths([os.path.join(REPO, "veneur_tpu_torch")])
    assert vs == [], "\n" + "\n".join(str(v) for v in vs)


def test_cli_exits_zero_on_clean_port():
    proc = subprocess.run(
        [sys.executable, "-m", "tools.vlint_torch", "veneur_tpu_torch"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "vlint: clean" in proc.stdout
