"""HK03 fixture: handlers that swallow a kernel build or launch failure
and serve the plain version (or nothing) instead."""

import logging

from veneur_tpu_torch.kernels import _build, lib
from veneur_tpu_torch.kernels import probe as kprobe
from veneur_tpu_torch.kernels.compress import fused_compress
from veneur_tpu_torch.ops.tdigest import compress_plain

log = logging.getLogger(__name__)


def compress_with_fallback(mean, weight, bv, bw, c):
    try:
        return fused_compress(mean, weight, bv, bw, c)
    except RuntimeError:                                         # HK03
        return compress_plain(mean, weight, bv, bw, c)


def build_or_none():
    try:
        return _build.load()
    except Exception:                                            # HK03
        log.warning("no kernels; running plain")
        return None


def probe_quietly(x, dev, stream):
    try:
        return lib().vt_probe(x.data_ptr(), x.numel(), dev, stream)
    except OSError:                                              # HK03
        return 1
    except ValueError:
        raise


def reraises(mean, weight, bv, bw, c):
    try:
        return fused_compress(mean, weight, bv, bw, c)
    except RuntimeError as e:
        log.error("compress failed: %s", e)
        raise


def unrelated_swallow(path):
    try:
        return open(path).read()
    except OSError:
        return ""


def documented(mean, weight, bv, bw, c):
    try:
        return fused_compress(mean, weight, bv, bw, c)
    # vlint: disable=HK03 reason=fixture-only demonstration of the
    # suppression syntax
    except RuntimeError:
        return None


class _Engine:
    def _setup_device(self, device):
        self.ok = kprobe.probe(device)

    def start(self, device):
        try:
            self._setup_device(device)
        except RuntimeError:                                     # HK03
            self.ok = False
