"""Minimal Sentry error reporting — the ConsumePanic analogue.

The reference wires raven/sentry-go so crashes reach Sentry before the
crash-only exit (server.go sym: ConsumePanic). No Sentry SDK is vendored
here, so this speaks the store API directly with stdlib urllib: parse
the DSN, build a minimal event (message, exception type, traceback),
POST fire-and-forget from a daemon thread so an unreachable Sentry can
never stall or crash the pipeline it is reporting on.

The port's copy of veneur_tpu/utils/sentry.py: the same events.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import traceback
import urllib.request
import uuid
from urllib.parse import urlparse

log = logging.getLogger("veneur_tpu_torch.sentry")


class SentryClient:
    def __init__(self, dsn: str, timeout_s: float = 3.0):
        u = urlparse(dsn)
        if not (u.scheme and u.hostname and u.username and u.path):
            raise ValueError(f"malformed sentry DSN")
        project = u.path.rsplit("/", 1)[-1]
        port = f":{u.port}" if u.port else ""
        self.endpoint = (f"{u.scheme}://{u.hostname}{port}"
                         f"/api/{project}/store/")
        self.auth = ("Sentry sentry_version=7, "
                     f"sentry_key={u.username}, sentry_client=veneur-tpu/1")
        self.timeout_s = timeout_s
        self.sent = 0
        self.dropped = 0

    def capture(self, exc: BaseException | None, message: str = "",
                wait: bool = False):
        """Fire-and-forget capture; `wait` blocks (used right before a
        crash-only exit so the event escapes the dying process)."""
        event = {
            "event_id": uuid.uuid4().hex,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S",
                                       time.gmtime()),
            "platform": "python",
            "logger": "veneur_tpu",
            "message": message or (str(exc) if exc else ""),
        }
        if exc is not None:
            event["exception"] = {"values": [{
                "type": type(exc).__name__,
                "value": str(exc),
                "stacktrace": {"frames": [
                    {"filename": f.filename, "function": f.name,
                     "lineno": f.lineno}
                    for f in traceback.extract_tb(exc.__traceback__)
                ]},
            }]}
        t = threading.Thread(target=self._send, args=(event,),
                             daemon=True)
        t.start()
        if wait:
            t.join(self.timeout_s + 0.5)

    def _send(self, event: dict):
        req = urllib.request.Request(
            self.endpoint, data=json.dumps(event).encode(),
            headers={"Content-Type": "application/json",
                     "X-Sentry-Auth": self.auth}, method="POST")
        try:
            # vlint: disable=RS01 reason=crash-path reporter: must fire
            # even when breakers are open and during the crash-only
            # exit, so it cannot depend on the resilience layer it
            # reports on; fire-and-forget with its own short timeout
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
            self.sent += 1
        except Exception as e:
            self.dropped += 1
            log.debug("sentry send failed: %s", e)
