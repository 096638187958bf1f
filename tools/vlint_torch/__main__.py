"""CLI: python -m tools.vlint_torch [paths...] — exit 0 iff clean."""

from __future__ import annotations

import argparse
import sys

from . import run_paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tools.vlint_torch",
        description="static analysis of the PyTorch/CUDA port")
    ap.add_argument("paths", nargs="*", default=["veneur_tpu_torch"],
                    help="files or directories to lint "
                         "(default: veneur_tpu_torch/)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress the summary line")
    args = ap.parse_args(argv)
    try:
        violations = run_paths(args.paths)
    except FileNotFoundError as e:
        print(f"vlint: no such path: {e}", file=sys.stderr)
        return 2
    for v in violations:
        print(v)
    if not args.quiet:
        n = len(violations)
        print(f"vlint: {n} violation{'s' if n != 1 else ''} "
              f"in {len(args.paths)} path(s)" if n else "vlint: clean")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
