"""HK03 good fixture: kernel failures propagate; a handler may log or
clean up and re-raise, and cleanup in `finally` is fine."""

import logging

from veneur_tpu_torch.kernels import probe as kprobe
from veneur_tpu_torch.kernels.compress import fused_compress

log = logging.getLogger(__name__)


def require_probe(device):
    if not kprobe.probe(device):
        raise RuntimeError(f"{device}: the probe kernel failed")


def compress_logged(mean, weight, bv, bw, c):
    try:
        return fused_compress(mean, weight, bv, bw, c)
    except RuntimeError as e:
        log.error("compress failed: %s", e)
        raise


def compress_timed(timer, mean, weight, bv, bw, c):
    timer.start()
    try:
        return fused_compress(mean, weight, bv, bw, c)
    finally:
        timer.stop()


def parse_or_default(text):
    try:
        return int(text)
    except ValueError:
        return 0
