"""Self-observation: the unified telemetry spine + the flight recorder
(the port's copy of veneur_tpu/observe/, behind the same exports).

One data model, three faces (flusher.go's self-instrumentation, grown
into a subsystem):

  * `registry.TelemetryRegistry` — the ONE registry every self-metric
    counter/gauge in the process flows through (the egress resilience
    counters, the durability journal counters, the server's ingest/
    flush/sink accounting). The registry is also the only module
    allowed to *name* `veneur.*` self-metrics (vlint TL01).
  * `recorder.FlightRecorder` — a bounded ring of per-flush-tick phase
    trees (drain / device dispatch / device exec / materialize / sink
    fan-out / forward ladder / journal ops), lock-cheap monotonic
    stamping, preallocated slots.
  * introspection — the recorder's `snapshot()` feeds the http_api's
    `/debug/flush` endpoint, `emit_spans()` feeds the SSF self-tracing
    client, and `registry.phase_timer_samples()` feeds phase durations
    back into the server's own engine as `veneur.flush.phase.*` timers.
"""

from .fleet import FleetView, ImportObserver
from .recorder import (FlightRecorder, TickRecord, current_scope,
                       current_tick, reset_current_tick,
                       set_current_tick)
from .registry import (DEFAULT_REGISTRY, SERVER_SCOPE, TelemetryRegistry,
                       e2e_timer_samples, fanout_timer_sample,
                       phase_timer_samples)

__all__ = [
    "DEFAULT_REGISTRY", "SERVER_SCOPE", "TelemetryRegistry",
    "phase_timer_samples", "e2e_timer_samples", "fanout_timer_sample",
    "FlightRecorder", "TickRecord", "FleetView", "ImportObserver",
    "current_tick", "current_scope", "set_current_tick",
    "reset_current_tick",
]
