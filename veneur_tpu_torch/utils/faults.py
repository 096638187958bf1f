"""Deterministic fault injection for the egress-resilience layer — the
port's copy of veneur_tpu/utils/faults.py.

A `FaultHarness` bundles an injectable monotonic clock with scripted
transports so every retry / circuit-breaker / spill-re-merge transition
in `veneur_tpu_torch/resilience.py` is unit-testable without sockets or real
sleeps: backoff sleeps advance the fake clock instead of the wall, and
each transport attempt consumes the next step of a failure schedule.

Schedule steps (a list, consumed left to right; the last step repeats
forever once the script is exhausted):

    "ok"              succeed (HTTP 200 / callable returns)
    "timeout"         raise TimeoutError
    "refused"         raise ConnectionRefusedError
    "reset"           raise ConnectionResetError
    "ack_lost"        the AMBIGUOUS failure: the receiver consumes and
                      applies the request body (the transport's
                      `deliver` callback runs / the callable's
                      delivery side effects happen), then the response
                      is dropped — raised as TimeoutError. The sender
                      cannot distinguish this from "timeout"; only an
                      idempotency envelope + receiver dedupe makes the
                      inevitable retry/replay safe.
    "kill"            simulated HARD KILL at this exact wire moment:
                      raises SimulatedKill, a BaseException, so it
                      escapes every `except Exception` recovery arm in
                      the egress/forwarder/flush stack exactly like
                      SIGKILL would end the process — no parking, no
                      journal appends, no breaker bookkeeping happen
                      after it. The kill-restart chaos harness uses it
                      to stop a sender mid-replay-ladder and then
                      rebuild it from the durability journal.
    "kill_after_send" the body is DELIVERED first (like "ack_lost"),
                      then the kill fires — the crash window between a
                      successful send and its journal DONE record,
                      where only receiver-side dedupe of the recovered
                      replay prevents a double count.
    503 (any int)     HTTP status: >=400 raises HTTPStatusError-shaped
                      failure via a fake response; <400 succeeds
    ("slow", dt)      advance the clock by dt seconds, then succeed
    ("slow", dt, s)   advance the clock by dt, then apply step `s`

`seeded_schedule` derives a reproducible random schedule from a seed —
the property-style way to exercise the retry ladder
(`ambiguous=True` mixes ack-loss into the fault pool).
"""

from __future__ import annotations

import random
import threading


class SimulatedKill(BaseException):
    """The scripted "kill" step. A BaseException on purpose: the
    resilience layer's retry loops, the forwarder's park-on-failure
    arms, and the flush loop's error counter all catch `Exception` —
    a real SIGKILL bypasses every one of them, so the simulation must
    too. Nothing (journal appends included) runs after this raises."""


def kill_journal_lock(journal_like):
    """Complete an in-process kill simulation: release the durability
    journal's advisory process lock the way a real SIGKILL would (the
    kernel closes the fd), WITHOUT flushing or closing the journal —
    everything the next incarnation knows it must learn from the bytes
    already on disk. Accepts a Journal or a ForwardJournal/
    WatermarkJournal façade."""
    journal = getattr(journal_like, "journal", journal_like)
    journal.release_lock()


class FakeClock:
    """Injected monotonic time. Use the instance itself as `clock=`
    (callable) and its .sleep as `sleep=`; sleeps advance time and are
    recorded so tests can assert the backoff ladder."""

    def __init__(self, start: float = 0.0):
        self._lock = threading.Lock()
        self._t = float(start)
        self.sleeps: list[float] = []

    def __call__(self) -> float:
        with self._lock:
            return self._t

    monotonic = __call__

    def sleep(self, dt: float):
        with self._lock:
            self.sleeps.append(dt)
            self._t += max(0.0, dt)

    def advance(self, dt: float):
        with self._lock:
            self._t += max(0.0, dt)


class _FakeResponse:
    """Duck-typed urllib response: .status, .close(), context manager."""

    def __init__(self, status: int = 200, body: bytes = b"{}"):
        self.status = status
        self._body = body

    def read(self) -> bytes:
        return self._body

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def seeded_schedule(seed: int, n: int, p_fail: float = 0.5,
                    ambiguous: bool = False):
    """Reproducible schedule of n steps ending in "ok" (so a bounded
    retry ladder can always terminate in tests that want delivery).
    `ambiguous=True` adds ack-loss (applied-then-dropped-response)
    to the fault pool — only safe to deliver through a deduping
    receiver."""
    rng = random.Random(seed)
    faults = ["timeout", "refused", 503, 500, ("slow", 0.05)]
    if ambiguous:
        faults = faults + ["ack_lost", "ack_lost"]
    steps = [rng.choice(faults) if rng.random() < p_fail else "ok"
             for _ in range(max(0, n - 1))]
    return steps + ["ok"]


class ScriptedTransport:
    """Scripted stand-in for the resilience layer's HTTP transport:
    `transport(req, timeout=None)` consumes one schedule step per call.
    Records every attempt as (monotonic_time, timeout, step, request)
    in `.calls` for timeline assertions.

    `deliver` (optional) is the RECEIVER: a callable(req) invoked for
    every step whose body reaches the other end — "ok", success
    statuses, and "ack_lost" (which applies the body, then drops the
    response). Wiring `deliver` to a real import endpoint turns the
    transport into an end-to-end ambiguous-failure chaos harness: the
    receiver's state advances while the sender sees a timeout. When
    `deliver` returns a response-like object, "ok" returns it."""

    def __init__(self, schedule, clock: FakeClock | None = None,
                 deliver=None):
        self.schedule = list(schedule) or ["ok"]
        self.clock = clock or FakeClock()
        self.deliver = deliver
        self.calls: list[tuple] = []
        self._lock = threading.Lock()
        self._i = 0

    def _next_step(self):
        with self._lock:
            step = self.schedule[min(self._i, len(self.schedule) - 1)]
            self._i += 1
        return step

    @property
    def attempts(self) -> int:
        with self._lock:
            return self._i

    def __call__(self, req=None, timeout=None):
        step = self._next_step()
        self.calls.append((self.clock(), timeout, step, req))
        return self._apply(step, req)

    def _deliver(self, req):
        return self.deliver(req) if self.deliver is not None else None

    def _apply(self, step, req=None):
        if isinstance(step, tuple) and step and step[0] == "slow":
            self.clock.advance(float(step[1]))
            inner = step[2] if len(step) > 2 else "ok"
            return self._apply(inner, req)
        if step == "kill":
            raise SimulatedKill("scripted hard kill (nothing sent)")
        if step == "kill_after_send":
            self._deliver(req)
            raise SimulatedKill("scripted hard kill (body was applied)")
        if step == "ack_lost":
            # the ambiguous failure: the body is consumed and APPLIED
            # by the receiver, then the response never makes it back
            self._deliver(req)
            raise TimeoutError("scripted ack lost (body was applied)")
        if isinstance(step, int):
            if step >= 400:
                # shaped like urllib: an error status raises, carrying
                # the code — classified retryable iff 5xx/408/429
                from ..resilience import HTTPStatusError
                raise HTTPStatusError("scripted", step)
            self._deliver(req)
            return _FakeResponse(step)
        if step == "ok":
            resp = self._deliver(req)
            return resp if resp is not None else _FakeResponse(200)
        if step == "timeout":
            raise TimeoutError("scripted timeout")
        if step == "refused":
            raise ConnectionRefusedError("scripted connection refused")
        if step == "reset":
            raise ConnectionResetError("scripted connection reset")
        raise ValueError(f"unknown fault step {step!r}")


class ScriptedCallable(ScriptedTransport):
    """The same schedule semantics for non-HTTP egress (forwarder
    callables, grpc sends, kafka producers): success returns the
    injected `result`, failures raise. Ignores its arguments so it can
    stand in for any call shape."""

    def __init__(self, schedule, clock: FakeClock | None = None,
                 result=None, on_success=None):
        super().__init__(schedule, clock)
        self.result = result
        self.on_success = on_success
        self.delivered: list = []

    def __call__(self, *args, timeout=None, **kwargs):
        step = self._next_step()
        self.calls.append((self.clock(), timeout, step, args))
        if step in ("ack_lost", "kill_after_send"):
            # ambiguous failure for callables: the delivery side
            # effects HAPPEN (recorded + on_success runs, e.g. a real
            # gRPC send underneath), then the ack is dropped — or the
            # whole process "dies" before observing it
            self.delivered.append(args)
            if self.on_success is not None:
                self.on_success(*args, **kwargs)
            if step == "kill_after_send":
                raise SimulatedKill(
                    "scripted hard kill (body was applied)")
            raise TimeoutError("scripted ack lost (body was applied)")
        out = self._apply(step)          # raises on fault steps
        self.delivered.append(args)
        if self.on_success is not None:
            return self.on_success(*args, **kwargs)
        return self.result if self.result is not None else out


class FaultHarness:
    """One-stop bundle for tests: a shared FakeClock, seeded RNG, and
    factories producing scripted transports and Egress objects wired to
    them. Constructed by the `fault_harness` conftest fixture."""

    def __init__(self, seed: int = 0):
        self.clock = FakeClock()
        self.rng = random.Random(seed)
        from ..resilience import ResilienceRegistry
        self.registry = ResilienceRegistry()

    def transport(self, schedule, deliver=None) -> ScriptedTransport:
        return ScriptedTransport(schedule, self.clock, deliver=deliver)

    def callable(self, schedule, **kw) -> ScriptedCallable:
        return ScriptedCallable(schedule, self.clock, **kw)

    def egress(self, destination: str = "test", schedule=("ok",),
               policy=None, transport=None):
        from ..resilience import Egress
        return Egress(
            destination, policy=policy,
            transport=(transport if transport is not None
                       else self.transport(schedule)),
            clock=self.clock, sleep=self.clock.sleep, rng=self.rng,
            registry=self.registry)
