"""YAML configuration, keeping veneur's flat key names (the port's copy
of veneur_tpu/config.py: the same keys, defaults, env overrides and
checks; `yaml` is imported inside `read_config`, so importing this module
needs no PyYAML).

Parity: config.go (sym: Config), config_parse.go (sym: ReadConfig —
YAML file + env-var overrides), example.yaml. A veneur operator's YAML
should drop in: the keys below are the reference's names; unknown keys
warn rather than error (veneur ignores them), and `VENEUR_`-prefixed
environment variables override file values like envconfig does.

New keys for the TPU engine (the north star's `aggregation_backend: tpu`)
are grouped at the bottom of the dataclass.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field, fields

from .ingest import parser

log = logging.getLogger("veneur_tpu_torch.config")


def _parse_interval(v) -> float:
    """veneur durations are Go-style strings ("10s", "500ms") or numbers
    of seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    units = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}
    for suffix in ("ms", "s", "m", "h"):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * units[suffix]
    return float(s)


@dataclass
class Config:
    # --- core (config.go names) ---
    interval: str = "10s"
    hostname: str = ""
    omit_empty_hostname: bool = False
    tags: list = field(default_factory=list)
    tags_exclude: list = field(default_factory=list)
    percentiles: list = field(default_factory=lambda: [0.5, 0.75, 0.99])
    aggregates: list = field(default_factory=lambda: ["min", "max", "count"])
    num_workers: int = 1          # engine shards (device axis on TPU)
    num_readers: int = 1          # UDP reader sockets (SO_REUSEPORT)
    metric_max_length: int = 4096
    read_buffer_size_bytes: int = 1 << 21  # SO_RCVBUF per UDP socket
    trace_max_length_bytes: int = 16384
    flush_max_per_body: int = 25000
    synchronize_with_interval: bool = False
    statsd_listen_addresses: list = field(default_factory=list)
    ssf_listen_addresses: list = field(default_factory=list)
    grpc_listen_addresses: list = field(default_factory=list)
    http_address: str = ""
    debug: bool = False
    enable_profiling: bool = False
    profile_port: int = 9943           # the torch.profiler capture port
    mutex_profile_fraction: int = 0    # accepted for YAML compat;
    block_profile_rate: int = 0        # Go-runtime-only, warned at start
    sentry_dsn: str = ""
    stats_address: str = ""

    # --- forwarding / cluster ---
    forward_address: str = ""
    forward_use_grpc: bool = True
    consul_forward_service_name: str = ""
    consul_refresh_interval: str = "30s"
    # --- wire compression (README "Wire compression") ---
    # Delta forwarding: each interval ships only the sketches the
    # dirty-slot bitmap saw touched (idle counter zeros / empty set
    # register banks stay home), with a periodic full resync and a
    # receiver-side gap check — a delta above a missed seq is refused
    # loudly (HTTP 409 / FAILED_PRECONDITION "delta-over-gap") and the
    # sender falls back to a full resync, so exactly-once still holds.
    # On by default: deltas are lossless for touched keys; the only
    # trade is that IDLE keys refresh the global's series liveness
    # once per resync instead of every interval.
    forward_delta: bool = True
    # every Nth forwarded interval is a full resync (re-ships every
    # active key, idle ones included); demotions/gap refusals force
    # one sooner. >= 1.
    forward_full_resync_intervals: int = 60
    # Centroid wire row: "lossless" (default — repeated f64 centroid
    # pairs, bit-exact) | "q16" (u16 affine-scaled means + varint
    # 1/8-fixed-point weights, ~4-5x smaller at bounded quantization
    # error; exact count/sum/min/max unaffected). Folded into the
    # engine/wire stamp ("h=tdigest/1q") so BOTH ends of a forwarding
    # pair must agree — a mixed fleet rejects loudly before decode.
    forward_centroid_codec: str = "lossless"

    # --- egress resilience (veneur_tpu/resilience.py) ---
    # Per-attempt socket timeout for every network egress (sinks +
    # forwarders); the reference hardcoded 10s per client.
    flush_timeout: str = "10s"
    retry_max_attempts: int = 3
    retry_backoff_base: str = "200ms"   # full-jitter: U(0, base*2^k)
    retry_backoff_cap: str = "5s"
    # per-flush, per-destination wall budget covering attempts, socket
    # timeouts AND backoff sleeps — one wedged vendor can't eat the tick
    retry_deadline: str = "8s"
    # consecutive failed DELIVERIES (each a full retry ladder) -> open;
    # the breaker records a call's final outcome, not per-attempt errors
    breaker_failure_threshold: int = 5
    breaker_open_duration: str = "30s"   # open -> half-open cooldown
    breaker_half_open_successes: int = 1  # probes to close again
    # re-merge spill buffer: failed forwards' sketches held for the next
    # interval (lossless for counters/histos/sets; gauges age out)
    spill_max_sketches: int = 65536
    spill_gauge_max_age_intervals: int = 4
    # failed intervals kept as distinct replay-ledger entries (each
    # replayed under its ORIGINAL idempotency envelope — exactly-once);
    # older entries fold into the merged spill tier above (at-least-once)
    spill_max_intervals: int = 8

    # --- exactly-once forward (idempotency envelope + dedupe ledger) ---
    # Sender identity stamped on every forwarded chunk. Default "" =
    # a fresh <hostname>-<pid>-<rand> per process start, so a restart
    # can never collide with its predecessor's receiver-side ledger.
    forward_sender_id: str = ""
    # Receiver side: the global tier's per-sender dedupe ledger.
    forward_dedupe_enabled: bool = True
    forward_dedupe_max_seqs_per_sender: int = 512
    forward_dedupe_max_senders: int = 1024
    forward_dedupe_ttl: str = "1h"   # idle senders forgotten after this

    # --- durable state (veneur_tpu/durability/) ---
    # Off by default: with durability disabled the flush path does zero
    # journal work and behavior is identical to the pre-durability tree
    # (regression-tested). When on, the sender's replay ladder + spill
    # tier and the receiver's dedupe watermarks survive a hard kill:
    # recovery runs before any listener binds, parked intervals replay
    # under their ORIGINAL envelopes, and a restarted global refuses
    # ancient replays it already flushed downstream.
    durability_enabled: bool = False
    durability_dir: str = "veneur-durability"
    # fsync policy: "always" (fsync per append — power-loss-proof,
    # slowest), "interval" (fsync at most once per
    # durability_fsync_interval plus every flush boundary — the
    # default; a process kill still loses nothing, only power loss can
    # cost up to one interval of records), "never" (leave syncing to
    # the kernel).
    durability_fsync: str = "interval"
    durability_fsync_interval: str = "1s"
    # snapshot+compact a journal once it outgrows this many bytes
    # (checked at flush boundaries; atomic write-temp/fsync/rename)
    durability_snapshot_journal_bytes: int = 1 << 22
    # Global-tier engine checkpointing: with durability on,
    # an IMPORT-tier server (a gRPC import listener, or is_global —
    # NOT http_address alone, which is also just the ops listener on
    # sending tiers; an HTTP-only global sets is_global: true)
    # additionally write-aheads every admitted import op and delta-
    # checkpoints its engines' merged sketch state (dirty piles only,
    # plus the interner key tables and staged imports) at each flush
    # boundary — a hard-killed global restarts with the fleet's
    # admitted-and-merged interval state, bit-identical at the next
    # flush. No effect on sending-only servers, with mesh engines
    # (sharded banks), or under native_ingest (the bridge owns the
    # interner). Requires durability_enabled.
    durability_engine_snapshot: bool = True
    # dirty fraction above which a checkpoint fetches whole bank
    # leaves and slices on host instead of a device-side row gather
    # (a near-full gather costs more than the contiguous fetch);
    # only the dirty rows are serialized either way. (0, 1].
    durability_engine_delta_threshold: float = 0.5

    # --- time-travel query tier (durability/history.py) ---
    # Retain a window of committed checkpoint generations (one per
    # closed flush interval: the boundary's checkpoint groups + the
    # interval's write-ahead import ops, sealed atomically and indexed
    # by interval-close wall time) and serve GET /query?metric=&q=&
    # t0=&t1= from them: historical percentiles, counts, and
    # cardinalities reconstructed into SCRATCH engines and merged
    # across intervals through the engine contract. 0 (the default)
    # = off: no history files, no query endpoint, zero write-path
    # cost. Requires durability_enabled + an engine-checkpointing
    # import tier (the same arming rule as durability_engine_snapshot;
    # mesh/native excluded). README "Time-travel queries".
    history_retention_generations: int = 0
    # additionally drop generations older than this relative to the
    # NEWEST retained close stamp ("0s" = count bound only)
    history_retention_seconds: str = "0s"
    # queries run on a dedicated executor (never the ingest/flush
    # path): its width, the bounded result cache (keyed on metric +
    # window + generation range), and the per-query wall timeout
    query_max_concurrent: int = 1
    query_cache_entries: int = 64
    query_timeout: str = "30s"

    # --- overload defense (veneur_tpu/ingest/admission.py) ---
    # Off by default: with the defense disabled the ingest path does
    # zero admission work and behavior is identical to the pre-defense
    # tree (regression-pinned). When on, per-prefix metric-key budgets
    # bound bank growth under a cardinality storm (over-budget keys
    # fold into the prefix's `__other__` sketch), and an adaptive
    # packet-shed governor engages when the flush tick overruns the
    # interval or worker queues saturate. Every degradation decision
    # is counted (`veneur.overload.*`); vlint OV01 machine-checks it.
    overload_defense_enabled: bool = False
    # live interned keys a prefix (the name up to the first separator)
    # may mint before new keys fold into `<prefix>.__other__`
    overload_max_keys_per_prefix: int = 65536
    # tracked prefixes; beyond this, new prefixes share one global
    # `__other__` key (bounds the controller's own memory)
    overload_max_prefixes: int = 4096
    overload_prefix_separator: str = "."
    overload_other_suffix: str = "__other__"
    # sampling applied to samples folding into a hot `__other__` key
    # (1.0 = fold everything); survivors are rate-corrected, so folded
    # counter totals / histogram weights stay unbiased
    overload_fold_sample_rate: float = 1.0
    # the governor's floor: adaptive packet admission never drops below
    # this rate, no matter how overloaded the tick signal reads
    overload_min_sample_rate: float = 0.05
    # a tick whose wall time exceeds this fraction of the flush
    # interval reads as overloaded (multiplicative shed-rate decrease)
    overload_tick_overrun_ratio: float = 0.8
    # worker-queue fill fraction that reads as overloaded
    overload_queue_high_watermark: float = 0.75
    # reset the per-prefix cardinality estimators every N flush ticks
    # (0 = never); the estimate is a per-window distinct-key count
    overload_estimator_window_intervals: int = 64
    # Huffman-Bucket estimator registers per prefix (power of two
    # >= 16; 256 gives ~6.5% relative error at 256 bytes/prefix)
    overload_sketch_buckets: int = 256
    # --- parser hardening (counted rejection, not unbounded keys) ---
    # metric names / individual tags longer than these are parse
    # errors (veneur.packet.error_total), never interned keys.
    # Defaults come from the parser so config-less library callers
    # (parse_metric/parse_packet directly) enforce the same bounds.
    metric_max_name_length: int = parser.MAX_NAME_LENGTH
    metric_max_tag_length: int = parser.MAX_TAG_LENGTH

    # --- observability (veneur_tpu/observe/) ---
    # Flight recorder: every flush tick records its phase tree (drain /
    # device dispatch / device exec / materialize / sink fan-out /
    # forward ladder / journal ops) into a bounded ring served by
    # GET /debug/flush and replayed as SSF spans through the server's
    # own trace client. Overhead is one monotonic_ns stamp + index bump
    # per phase edge (bench_suite c13 pins it under 1% of the tick).
    flight_recorder: bool = True
    flight_recorder_ticks: int = 32        # ring: last N ticks kept
    flight_recorder_max_phases: int = 192  # per-tick phase slot budget
    # Dogfood loop: re-ingest each tick's top-level phase durations as
    # LOCAL-ONLY `veneur.flush.phase.*` timers, so the engine serves
    # percentiles of its own flush phases like any tenant metric.
    flush_phase_timers: bool = True
    # On-demand torch.profiler capture around flush ticks, triggered via
    # GET /debug/flush/profile?ticks=N. Off by default: a profiler
    # capture is a debug action an operator must opt into.
    debug_flush_profile: bool = False
    debug_flush_profile_dir: str = "veneur-profile"
    # Fleet-scope tracing, receiver half (observe/fleet.py): the
    # per-sender e2e/freshness view behind GET /debug/fleet. Bounds:
    # distinct sender ids tracked (LRU past the bound) and the rolling
    # e2e sample window per sender serving the endpoint's p50/p99.
    # Sender-side trace stamping needs no knob — it derives from the
    # flight recorder's tick identity and encodes to nothing when the
    # recorder is off.
    fleet_max_senders: int = 1024
    fleet_e2e_window: int = 256

    # --- TLS (statsd/SSF stream listeners) ---
    tls_key: str = ""
    tls_certificate: str = ""
    tls_authority_certificate: str = ""

    # --- watchdog / lifecycle ---
    flush_watchdog_missed_flushes: int = 0

    # --- SSF / tracing ---
    indicator_span_timer_name: str = ""
    ssf_buffer_size: int = 16384   # span worker queue depth

    # --- sinks ---
    datadog_api_key: str = ""
    datadog_api_hostname: str = "https://app.datadoghq.com"
    datadog_flush_max_per_body: int = 25000
    datadog_trace_api_address: str = ""   # local APM agent, e.g.
    #                                       http://127.0.0.1:8126
    signalfx_api_key: str = ""
    signalfx_endpoint_base: str = "https://ingest.signalfx.com"
    signalfx_vary_key_by: str = ""
    kafka_broker: str = ""
    kafka_topic: str = ""
    kafka_metric_topic: str = ""
    kafka_span_topic: str = ""
    splunk_hec_address: str = ""
    splunk_hec_token: str = ""
    newrelic_account_id: int = 0
    newrelic_insert_key: str = ""
    lightstep_access_token: str = ""
    lightstep_collector_host: str = "https://collector.lightstep.com"
    xray_address: str = ""
    falconer_address: str = ""
    prometheus_repeater_address: str = ""
    flush_file: str = ""          # localfile plugin target
    aws_s3_bucket: str = ""
    aws_region: str = ""
    aws_access_key_id: str = ""
    aws_secret_access_key: str = ""

    # --- TPU engine (new; the north star's aggregation_backend key) ---
    # "cpu" runs the port's Server on the CPU; any other value on the
    # card (the key keeps the reference's name and default)
    aggregation_backend: str = "tpu"
    # Sketch-engine selection (veneur_tpu/sketches/).
    # histogram_backend: "tdigest" (default; absolute-rank k1 digest,
    # tight mid-range percentiles) | "req" (relative-error adaptive
    # compactors: ~1% p99.9 value error on heavy-tailed streams where
    # t-digest clusters blur the tail; mid-range is distribution-
    # dependent — see README "Sketch engines").
    # set_backend: "hll" (default; LogLog-Beta, 2^p u8 registers) |
    # "ull" (UltraLogLog, arxiv 2308.16862: ~half the register bytes
    # at equal nominal error via an ML estimator).
    # BOTH ends of a forwarding pair must run the SAME engines: every
    # forward request carries an engine/wire stamp and a mismatched
    # receiver rejects loudly (veneur.import.engine_mismatch_total,
    # per-sender at /debug/fleet) instead of merging incompatible
    # sketches. Not supported with native_ingest or tpu_num_devices>1
    # (those own their banks).
    histogram_backend: str = "tdigest"
    set_backend: str = "hll"
    tpu_ull_precision: int = 13        # ULL registers = 2^p bytes/slot
    tpu_req_levels: int = 2            # REQ compactor levels
    tpu_req_capacity: int = 256        # items per level per slot
    tpu_histogram_slots: int = 1 << 15
    tpu_counter_slots: int = 1 << 14
    tpu_gauge_slots: int = 1 << 14
    tpu_set_slots: int = 1 << 12
    tpu_batch_size: int = 8192
    tpu_buffer_depth: int = 256
    tpu_compression: float = 100.0
    tpu_hll_precision: int = 14
    tpu_slot_idle_ttl_intervals: int = 16
    tpu_num_devices: int = 0           # 0 = all visible devices
    # Flush-result fetch strategy: "sync" | "staged" | "host" | "async".
    # Non-sync modes work around relayed backends where a synchronous
    # device_get invalidates the serving executable (TPU_EVIDENCE_r04.md).
    tpu_flush_fetch: str = "sync"
    # Compact wire mode: quantile/min/max columns fetched as f16 with
    # sentinel-gated full-precision fallback; count/sum stay exact.
    # Halves the flush fetch on transport-constrained rigs. Not
    # supported with multi-device engines.
    tpu_flush_fetch_f16: bool = False
    # Incremental dirty-slot flush: the flush program
    # consumes the delta-checkpoint dirty bitmap and compresses/
    # materializes ONLY the piles touched this interval — cold piles
    # keep their fresh-init state and baseline rows verbatim,
    # bit-identical to the full program. Above the threshold dirty
    # fraction (histogram bank) the full program runs instead. Ignored
    # (always full) with tpu_num_devices > 1 — the mesh engine owns
    # sharded banks with no per-slot bitmaps.
    tpu_flush_incremental: bool = True
    tpu_flush_incremental_threshold: float = 0.75
    # Double-buffered flush: the tick boundary only retires
    # the interval under the ingest lock (one rebind into shadow
    # banks); draining, import landing, and the flush program run
    # outside it, so admit/ingest never stalls behind the flush
    # executable or materialize. Off = legacy drain-under-lock
    # ordering (the mesh engine always uses legacy).
    tpu_flush_double_buffer: bool = True
    # Hand-written kernels: "auto" and "on" run them (the port's
    # Server has no path without them and refuses "off"); the key keeps
    # the reference's name and values.
    tpu_fused_kernels: str = "auto"

    # --- native C++ ingest bridge (native/vtpu_ingest.cpp) ---
    # When on, UDP DogStatsD ingest (readers + parse + key interning +
    # batch assembly) runs in the C++ bridge and Python only pumps
    # device-ready batches; one engine owns the full slot space.
    native_ingest: bool = False
    native_ring_capacity: int = 1 << 20
    # Pump dispatch width (decoupled from tpu_batch_size, which sizes the
    # per-sample staging path). Wider batches amortize per-dispatch cost
    # (moderately on CPU — the t-digest scatter program is ~30ms/dispatch
    # nearly flat in width; substantially on TPU, where dispatch+transfer
    # overhead dominates the sub-ms kernel). 32k balances that against
    # drain latency at flush time. See BENCH_SUITE c8_s5* and the
    # buffer-aliasing note in NativePump._pump_bank.
    native_pump_batch: int = 1 << 15

    # populated by the loader, not a YAML key:
    is_global: bool = False

    @property
    def interval_seconds(self) -> float:
        return _parse_interval(self.interval)

    @property
    def consul_refresh_seconds(self) -> float:
        return _parse_interval(self.consul_refresh_interval)

    @property
    def flush_timeout_seconds(self) -> float:
        return _parse_interval(self.flush_timeout)


_FIELDS = {f.name: f for f in fields(Config)}


def read_config(path: str | None = None, text: str | None = None,
                env: dict | None = None) -> Config:
    """ReadConfig: YAML file -> Config, with VENEUR_<UPPER_KEY> env
    overrides (the envconfig behavior). Parsing YAML needs PyYAML;
    `read_config(env=...)` alone does not."""
    raw = {}
    if text is not None or path is not None:
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                "read_config needs PyYAML (the yaml module) to parse a "
                "config file; build a Config() directly instead") from e
    if text is not None:
        raw = yaml.safe_load(text) or {}
    elif path is not None:
        with open(path) as f:
            raw = yaml.safe_load(f) or {}

    cfg = Config()
    for k, v in raw.items():
        if k in _FIELDS:
            setattr(cfg, k, _coerce(k, v))
        else:
            log.warning("unknown config key %r ignored", k)

    env = os.environ if env is None else env
    for name in _FIELDS:
        ev = env.get("VENEUR_" + name.upper())
        if ev is not None:
            setattr(cfg, name, _coerce(name, ev))
    _validate(cfg)
    return cfg


_KNOWN_AGGREGATES = {"min", "max", "sum", "avg", "count", "median",
                     "hmean"}


def _validate(cfg: Config) -> None:
    """Reject configs that would fail obscurely later (bad percentiles
    clip silently in the quantile kernel; zero intervals spin the flush
    loop). Unknown aggregates warn, like veneur's lenient parsing."""
    for p in cfg.percentiles:
        if not (0.0 < float(p) < 1.0):
            raise ValueError(
                f"percentile {p} out of range (0, 1) exclusive")
    if len(cfg.percentiles) > 8:
        # the flush program's quantile interpolation unrolls over the
        # percentile list (a deliberate lane-efficiency trade at the
        # default 3-4): each extra percentile re-reads the full knot
        # matrix, so very long lists scale the flush cost linearly
        log.warning(
            "%d percentiles configured: flush cost grows linearly with "
            "the percentile count (the quantile program unrolls over "
            "it); typical deployments use 3-4", len(cfg.percentiles))
    if cfg.interval_seconds <= 0:
        raise ValueError(f"interval must be positive: {cfg.interval!r}")
    if cfg.durability_fsync not in ("always", "interval", "never"):
        raise ValueError(
            "durability_fsync must be one of always/interval/never, "
            f"got {cfg.durability_fsync!r}")
    if cfg.durability_enabled and not cfg.durability_dir:
        raise ValueError(
            "durability_enabled requires a durability_dir")
    if cfg.durability_snapshot_journal_bytes < 4096:
        raise ValueError(
            "durability_snapshot_journal_bytes must be >= 4096 "
            "(a snapshot cycle per append would thrash the disk)")
    if not (0.0 < cfg.durability_engine_delta_threshold <= 1.0):
        raise ValueError(
            "durability_engine_delta_threshold must be in (0, 1]: it "
            "is the dirty fraction above which a checkpoint switches "
            "from row gather to whole-leaf fetch, got "
            f"{cfg.durability_engine_delta_threshold!r}")
    if cfg.history_retention_generations < 0:
        raise ValueError(
            "history_retention_generations must be >= 0 (0 = "
            "time-travel tier off)")
    if cfg.history_retention_generations > 0 and \
            not cfg.durability_enabled:
        raise ValueError(
            "history_retention_generations requires "
            "durability_enabled (the time-travel tier reads the "
            "engine checkpoint journal)")
    if _parse_interval(cfg.history_retention_seconds) < 0:
        raise ValueError(
            "history_retention_seconds must be >= 0 (0 = no age "
            "bound)")
    if cfg.query_max_concurrent < 1:
        raise ValueError("query_max_concurrent must be >= 1")
    if cfg.query_cache_entries < 0:
        raise ValueError("query_cache_entries must be >= 0")
    if _parse_interval(cfg.query_timeout) <= 0:
        raise ValueError("query_timeout must be a positive duration")
    for key in ("flush_timeout", "retry_backoff_base",
                "retry_backoff_cap", "retry_deadline",
                "breaker_open_duration", "forward_dedupe_ttl",
                "durability_fsync_interval"):
        if _parse_interval(getattr(cfg, key)) <= 0:
            raise ValueError(
                f"{key} must be a positive duration: "
                f"{getattr(cfg, key)!r}")
    for key in ("retry_max_attempts", "breaker_failure_threshold",
                "breaker_half_open_successes", "spill_max_intervals",
                "forward_dedupe_max_seqs_per_sender",
                "forward_dedupe_max_senders",
                "forward_full_resync_intervals"):
        if getattr(cfg, key) < 1:
            raise ValueError(f"{key} must be >= 1")
    if cfg.forward_centroid_codec not in ("lossless", "q16"):
        raise ValueError(
            "forward_centroid_codec must be lossless or q16, got "
            f"{cfg.forward_centroid_codec!r} (both ends of a "
            "forwarding pair must run the same codec — it is part of "
            "the engine/wire stamp)")
    if cfg.flight_recorder_ticks < 1 or \
            cfg.flight_recorder_max_phases < 8:
        raise ValueError(
            "flight_recorder_ticks must be >= 1 and "
            "flight_recorder_max_phases >= 8 (a tick's fixed phases "
            "alone need that many slots)")
    if cfg.fleet_max_senders < 1 or cfg.fleet_e2e_window < 8:
        raise ValueError(
            "fleet_max_senders must be >= 1 and fleet_e2e_window >= 8 "
            "(a p99 over fewer samples is noise)")
    for key in ("overload_max_keys_per_prefix", "overload_max_prefixes"):
        if getattr(cfg, key) < 1:
            raise ValueError(f"{key} must be >= 1")
    for key in ("overload_fold_sample_rate", "overload_min_sample_rate"):
        v = getattr(cfg, key)
        if not (0.0 < v <= 1.0):
            raise ValueError(f"{key} must be in (0, 1], got {v!r}")
    if cfg.overload_tick_overrun_ratio <= 0:
        raise ValueError("overload_tick_overrun_ratio must be positive")
    if not (0.0 < cfg.overload_queue_high_watermark <= 1.0):
        raise ValueError(
            "overload_queue_high_watermark must be in (0, 1]")
    if cfg.overload_estimator_window_intervals < 0:
        raise ValueError(
            "overload_estimator_window_intervals must be >= 0 "
            "(0 = never reset)")
    b = cfg.overload_sketch_buckets
    if b < 16 or (b & (b - 1)):
        raise ValueError(
            "overload_sketch_buckets must be a power of two >= 16, "
            f"got {b}")
    if cfg.overload_defense_enabled and not cfg.overload_prefix_separator:
        raise ValueError(
            "overload_defense_enabled requires a non-empty "
            "overload_prefix_separator")
    for key in ("metric_max_name_length", "metric_max_tag_length"):
        if getattr(cfg, key) < 16:
            raise ValueError(
                f"{key} must be >= 16 (shorter limits would reject "
                "ordinary metric traffic)")
    if cfg.debug_flush_profile and not cfg.debug_flush_profile_dir:
        raise ValueError(
            "debug_flush_profile requires a debug_flush_profile_dir")
    if cfg.spill_max_sketches < 0 or \
            cfg.spill_gauge_max_age_intervals < 0:
        raise ValueError(
            "spill_max_sketches / spill_gauge_max_age_intervals "
            "must be >= 0")
    unknown = [a for a in cfg.aggregates
               if a not in _KNOWN_AGGREGATES]
    if unknown:
        log.warning("unknown aggregates %r ignored (known: %s)",
                    unknown, sorted(_KNOWN_AGGREGATES))
    for key in ("tpu_histogram_slots", "tpu_counter_slots",
                "tpu_gauge_slots", "tpu_set_slots", "tpu_batch_size",
                "native_pump_batch"):
        if getattr(cfg, key) <= 0:
            raise ValueError(f"{key} must be positive")
    if cfg.tpu_buffer_depth < 8:
        raise ValueError("tpu_buffer_depth must be >= 8")
    if not (4 <= cfg.tpu_hll_precision <= 16):
        raise ValueError("tpu_hll_precision must be in [4, 16]")
    if cfg.histogram_backend not in ("tdigest", "req"):
        raise ValueError(
            f"histogram_backend must be tdigest or req, got "
            f"{cfg.histogram_backend!r}")
    if cfg.set_backend not in ("hll", "ull"):
        raise ValueError(
            f"set_backend must be hll or ull, got {cfg.set_backend!r}")
    if not (4 <= cfg.tpu_ull_precision <= 16):
        raise ValueError("tpu_ull_precision must be in [4, 16]")
    if cfg.tpu_req_levels < 1 or cfg.tpu_req_capacity < 32 \
            or cfg.tpu_req_capacity % 8:
        raise ValueError(
            "tpu_req_levels must be >= 1 and tpu_req_capacity a "
            "multiple of 8 >= 32 (the compactor's protect/trigger "
            "sections need the room)")
    if (cfg.histogram_backend != "tdigest"
            or cfg.set_backend != "hll"):
        if cfg.native_ingest:
            raise ValueError(
                "non-default sketch backends are not supported with "
                "native_ingest (the C++ bridge computes HLL updates)")
        if cfg.tpu_num_devices > 1:
            raise ValueError(
                "non-default sketch backends are not supported with "
                "tpu_num_devices > 1 (the mesh engine owns its banks)")
    if cfg.tpu_flush_fetch_f16 and cfg.tpu_num_devices > 1:
        raise ValueError(
            "tpu_flush_fetch_f16 is not supported with tpu_num_devices > 1 "
            "(the mesh flush program has its own wire layout)")
    if cfg.tpu_flush_fetch not in ("sync", "staged", "host", "async"):
        raise ValueError(
            "tpu_flush_fetch must be one of sync/staged/host/async")
    if not (0.0 < cfg.tpu_flush_incremental_threshold <= 1.0):
        raise ValueError(
            "tpu_flush_incremental_threshold must be in (0, 1]: the "
            "dirty fraction above which the full flush program runs")
    if cfg.tpu_fused_kernels not in ("auto", "on", "off"):
        raise ValueError(
            "tpu_fused_kernels must be one of auto/on/off")
    if cfg.tpu_fused_kernels != "off" and cfg.tpu_num_devices > 1:
        # the mesh engine builds its own sharded flush program and
        # never consults the kernel arm — not an error (auto is the
        # default everywhere), but "on" deserves a loud note
        if cfg.tpu_fused_kernels == "on":
            log.warning(
                "tpu_fused_kernels=on is ignored with "
                "tpu_num_devices > 1: the mesh engine serves its own "
                "sharded flush program (XLA arm)")
    # t-digest centroid capacity is ~2*compression (fixed 100), padded to
    # 128 lanes. A buffer shallower than that makes the global import
    # path pay ceil(C/B) compress dispatches per landing round —
    # quadratic-ish for tiny buffers. Legal, but worth a loud warning.
    if cfg.tpu_buffer_depth < 256:
        log.warning(
            "tpu_buffer_depth=%d is below the t-digest centroid "
            "capacity (256): forwarded-digest imports will pay %d "
            "compress dispatches per landing round instead of 1",
            cfg.tpu_buffer_depth, -(-256 // cfg.tpu_buffer_depth))
    if cfg.stats_address:
        host, sep, port = cfg.stats_address.rpartition(":")
        if (not sep or not port.isdigit()
                or not (0 < int(port) < 65536)
                or (":" in host
                    and not (host.startswith("[")
                             and host.endswith("]")))):
            raise ValueError(
                f"stats_address must be host:port (IPv6 hosts "
                f"bracketed), got {cfg.stats_address!r}")


def _coerce(name: str, v):
    f = _FIELDS[name]
    t = f.type
    if t == "bool" or isinstance(f.default, bool):
        if isinstance(v, str):
            return v.strip().lower() in ("1", "true", "yes", "on")
        return bool(v)
    if isinstance(f.default, int) and not isinstance(f.default, bool):
        return int(v)
    if isinstance(f.default, float):
        return float(v)
    if t == "list" or "list" in str(t):
        if isinstance(v, str):
            v = [s.strip() for s in v.split(",") if s.strip()]
        v = list(v)
        if name == "percentiles":  # float-element list keys
            v = [float(x) for x in v]
        return v
    return v
