"""S3 plugin: archive each interval's full flush as gzipped TSV objects.

Parity: plugins/s3/s3.go (sym: S3Plugin.Flush — encodes the interval's
[]InterMetric as TSV, gzips, and PutObjects under
`<hostname>/<date>/<timestamp>.tsv.gz`).

The AWS SDK is not available in this image, so the uploader is
injectable: anything callable as `put(bucket, key, body_bytes)`.
`start()` builds one from boto3 when importable; without it the plugin
drops (counted) instead of failing the flush fan-out — egress is lossy,
the pipeline is not.

The port's copy of veneur_tpu/sinks/s3.py: the same payloads, over the
port's resilience layer.
"""

from __future__ import annotations

import gzip
import io
import logging
import time

from . import Plugin
from .basic import tsv_from_frames, tsv_line

log = logging.getLogger("veneur_tpu_torch.sinks.s3")


def _default_uploader(region: str, access_key: str, secret_key: str):
    try:
        import boto3  # type: ignore
    except ImportError:
        return None
    kw = {}
    if region:
        kw["region_name"] = region
    if access_key:
        kw["aws_access_key_id"] = access_key
        kw["aws_secret_access_key"] = secret_key
    client = boto3.client("s3", **kw)

    def put(bucket: str, key: str, body: bytes):
        client.put_object(Bucket=bucket, Key=key, Body=body)

    return put


def object_key(hostname: str, ts: float | None = None) -> str:
    """`<hostname>/<yyyy>/<mm>/<dd>/veneur-<epoch>.tsv.gz` — the
    reference's date-partitioned layout."""
    t = time.time() if ts is None else ts
    tm = time.gmtime(t)
    return (f"{hostname or 'unknown'}/{tm.tm_year:04d}/{tm.tm_mon:02d}/"
            f"{tm.tm_mday:02d}/veneur-{int(t)}.tsv.gz")


class S3Plugin(Plugin):
    def __init__(self, bucket: str, region: str = "",
                 access_key: str = "", secret_key: str = "",
                 interval_s: int = 10, uploader=None, egress=None,
                 egress_policy=None):
        from ..resilience import Egress
        self.bucket = bucket
        self.region = region
        self.access_key = access_key
        self.secret_key = secret_key
        self.interval_s = interval_s
        self.uploader = uploader
        self._egress = egress or Egress(f"s3://{bucket}",
                                        policy=egress_policy)
        self.uploaded_total = 0
        self.dropped_total = 0
        if self.uploader is None:
            self.uploader = _default_uploader(region, access_key,
                                              secret_key)
            if self.uploader is None:
                log.warning("s3: boto3 unavailable; interval archives "
                            "to bucket %r will be dropped (counted)",
                            bucket)

    def name(self) -> str:
        return "s3"

    def _upload(self, lines, n: int, hostname: str):
        """Gzip `lines` (TSV rows) and PutObject; shared by the legacy
        and frame-native flush paths."""
        if not n:
            return
        if self.uploader is None:
            # vlint: disable=TH01 reason=flush-path-only counters: the
            # server keeps one flush of a plugin in flight
            # (Server._fan_out), and flush/flush_frames are never
            # concurrent
            self.dropped_total += n
            return
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb") as gz:
            for line in lines:
                gz.write(line.encode())
        try:
            self._egress.call(self.uploader, self.bucket,
                              object_key(hostname), buf.getvalue())
            # vlint: disable=TH01 reason=flush-path-only counter (above)
            self.uploaded_total += n
        except Exception as e:
            # vlint: disable=TH01 reason=flush-path-only counter (above)
            self.dropped_total += n
            log.error("s3 upload failed (%d metrics dropped): %s", n, e)

    def flush(self, metrics, hostname):
        self._upload((tsv_line(m, hostname, self.interval_s)
                      for m in metrics), len(metrics), hostname)

    def flush_frames(self, frames, hostname):
        self._upload(tsv_from_frames(frames, hostname, self.interval_s),
                     len(frames), hostname)
