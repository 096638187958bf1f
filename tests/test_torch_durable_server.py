"""Kill-restart chaos on the port: the durability journals under hard
kills of the sender, the receiver and the global tier
(tests/test_exactly_once_chaos.py with the port in place of the
reference, servers on the CPU through `aggregation_backend: cpu`).

Topology (all real, in-process): seeded UDP traffic -> local Server
(real socket, real workers, manual flush ticks) -> ResilientForwarder
-> HttpJsonForwarder whose egress transport is a ScriptedTransport
with `deliver=` wired to REAL HTTP POSTs against the global Server's
/import, so an "ack_lost" step genuinely applies the body at the
global tier and then drops the response.

The scripted "kill" fault step (a BaseException, like SIGKILL) stops
the sender mid-replay-ladder; a SECOND sender incarnation recovers the
ladder from the journal and resumes under the ORIGINAL envelopes, and
the global's flushed state must be bit for bit a zero-fault oracle's.
A hard-killed durable global restarts from its engine journal (the
latest committed checkpoint group, then the write-ahead import ops
above its watermark) and flushes bit for bit what an uncrashed twin
flushes; persisted watermarks refuse ancient replays; a torn checkpoint
group falls back to the previous one; /ready reports the recovery; and
durability off is inert. The port-only cases at the end run the same
kill over the gRPC import path and hold the port's durable surfaces
against the reference's keys.
"""

import json
import os
import random
import socket
import time
import urllib.request

import numpy as np
import pytest

from veneur_tpu_torch.cluster.forward import HttpJsonForwarder
from veneur_tpu_torch.cluster.importsrv import DedupeLedger
from veneur_tpu_torch.cluster.wire import envelope_headers
from veneur_tpu_torch.config import read_config
from veneur_tpu_torch.durability import ForwardJournal
from veneur_tpu_torch.resilience import (BreakerPolicy, Egress, EgressPolicy,
                                   ResilienceRegistry,
                                   ResilientForwarder, RetryPolicy)
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink
from veneur_tpu_torch.utils.faults import (FakeClock, ScriptedTransport,
                                     SimulatedKill, kill_journal_lock,
                                     seeded_schedule)

_SERVER_YAML = """
interval: "3600s"
aggregation_backend: cpu
num_workers: 1
percentiles: [0.5, 0.99]
aggregates: ["min", "max", "count"]
hostname: h
tpu_histogram_slots: 512
tpu_counter_slots: 512
tpu_gauge_slots: 512
tpu_set_slots: 256
tpu_batch_size: 256
tpu_buffer_depth: 256
"""


class _RoundTransport:
    """Mutable slot so each chaos round installs a fresh scripted
    schedule on the same Egress."""

    def __init__(self):
        self.current = None

    def __call__(self, req, timeout=None):
        return self.current(req, timeout=timeout)


def _mk_global(reg: ResilienceRegistry):
    cfg = read_config(text=_SERVER_YAML)
    cfg.http_address = "127.0.0.1:0"
    cfg.is_global = True
    sink = CaptureMetricSink()
    srv = Server(cfg, sinks=[sink], plugins=[])
    # dedicated registry so local-server self-metric drains between
    # rounds can't eat the duplicate counters this test asserts on
    srv.dedupe_ledger = DedupeLedger(registry=reg)
    srv.start()
    return srv, sink


def _mk_local(forwarder):
    cfg = read_config(text=_SERVER_YAML)
    cfg.statsd_listen_addresses = ["udp://127.0.0.1:0"]
    cfg.forward_address = "placeholder:1"   # enables forward exports
    srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[],
                 forwarder=forwarder)
    srv.start()
    return srv


def _round_lines(r: int, rng: np.random.Generator) -> bytes:
    """One round's traffic as a single datagram: 4 timer keys (digest
    forwards), a set, and two global-only counters — ~9 jsonmetric
    entries per flush, i.e. 3 wire chunks at max_per_body=3."""
    lines = []
    for k in range(4):
        for v in rng.normal(100 + 10 * k, 5, 5):
            lines.append(b"chaos.t%d:%.4f|ms" % (k, v))
    for u in range(3):
        lines.append(b"chaos.uniq:u%d-%d|s" % (r % 4, u))
    lines.append(b"chaos.total:%d|c|#veneurglobalonly" % (r + 1))
    lines.append(b"chaos.extra:2|c|#veneurglobalonly")
    return b"\n".join(lines)


def _run(schedules: list, seed: int = 7):
    """Drive the full topology over len(schedules) rounds; returns
    (global flushed metrics, duplicate-drop count, forwarder)."""
    reg = ResilienceRegistry()
    glob, _gsink = _mk_global(reg)
    clock = FakeClock()
    rt = _RoundTransport()
    egress = Egress(
        "chaos-global",
        policy=EgressPolicy(
            retry=RetryPolicy(max_attempts=3, base_backoff_s=0.001,
                              max_backoff_s=0.002, deadline_s=120.0),
            breaker=BreakerPolicy(failure_threshold=10_000)),
        transport=rt, clock=clock, sleep=clock.sleep,
        rng=random.Random(42), registry=reg)
    base = f"http://127.0.0.1:{glob.http_api.port}"
    inner = HttpJsonForwarder(base, timeout_s=5.0, max_per_body=3,
                              egress=egress)

    def deliver(req):
        return urllib.request.urlopen(req, timeout=5)

    fwd = ResilientForwarder(inner, destination="chaos-global",
                             sender_id="chaos-sender", registry=reg)
    local = _mk_local(fwd)
    try:
        port = local.bound_port()
        c = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rng = np.random.default_rng(seed)
        for r, schedule in enumerate(schedules):
            rt.current = ScriptedTransport(schedule, clock,
                                           deliver=deliver)
            c.sendto(_round_lines(r, rng), ("127.0.0.1", port))
            deadline = time.time() + 10
            while local.packets_received < 1 and time.time() < deadline:
                time.sleep(0.005)
            assert local.packets_received >= 1, "datagram lost"
            assert local.drain(10.0)
            local.flush_once(timestamp=1000 + r)   # forward faults are
            clock.advance(10.0)                    # caught + spilled
        c.close()
        assert glob.drain(10.0)
        out = sorted(
            (m.name, tuple(m.tags), str(m.type), m.value)
            for m in glob.flush_once(timestamp=9999)
            if not m.name.startswith("veneur."))
        dups = reg.peek("import", "forward.duplicates_dropped")
        pending = fwd.pending_spill
    finally:
        local.stop()
        glob.stop()
    return out, dups, pending


# the scripted storms: ack-loss (ambiguous), 503 retry ladders, a
# partial delivery (chunk 1 of 3 dies after being applied), a full
# outage, recovery, then three seeded ambiguous storms and two clean
# drain rounds. The oracle run replaces every schedule with ["ok"].
_CHAOS_SCHEDULES = [
    ["ok"],
    ["ack_lost", "ok"],                    # retry after ambiguous loss
    [503, 503, "ok"],                      # clean retry ladder
    ["ok", "ack_lost", "timeout", "timeout"],   # partial: applied tail
    ["refused"],                           # full outage: park + replay
    ["ok"],                                # recovery: replay storm
    ["ok"],
    seeded_schedule(101, 8, p_fail=0.6, ambiguous=True),
    seeded_schedule(102, 8, p_fail=0.6, ambiguous=True),
    seeded_schedule(103, 8, p_fail=0.6, ambiguous=True),
    ["ok"],
    ["ok"],
]


# =====================================================================
# Kill-restart chaos: the durability journal under a hard sender kill
# mid-replay-ladder, and a receiver restart against ancient replays.
# =====================================================================

def _hard_kill_local(srv):
    """Simulate SIGKILL for the journal's purposes: stop threads and
    release the sockets so the test can proceed in-process, but run
    NONE of the graceful-shutdown hooks — no journal sync/close, no
    drain, no forwarder close. Everything the new incarnation knows, it
    must learn from the journal files."""
    srv._stop.set()
    for s in srv._sockets + srv._listen_socks:
        try:
            s.close()
        except OSError:
            pass


def _run_with_kill(tmp_path, seed: int = 7):
    """The crashing arm: same topology as _run, but the forwarder
    journals to tmp_path, round 3's transport hard-kills the sender
    mid-replay-ladder (one replay delivered, then SimulatedKill), and
    rounds 4+ run in a SECOND incarnation recovered from the journal.

    Round script (seq = round + 1 in both arms):
      r0  ok
      r1  ack_lost then timeouts — chunk 0 APPLIED at the global, the
          interval parks anyway (the ambiguous failure)
      r2  503s — r1's replay fails, r2 parks behind it
      r3  ok, kill — r1 replays (global dedupes chunk 0), then the
          process "dies" with [r2, r3] still parked
      --- hard kill + restart from the journal ---
      r4  ok — recovered ladder replays r2, r3 under their ORIGINAL
          envelopes, then r4 ships
      r5  ok
    """
    reg = ResilienceRegistry()
    glob, _gsink = _mk_global(reg)
    clock = FakeClock()
    rt = _RoundTransport()

    def mk_egress():
        return Egress(
            "chaos-global",
            policy=EgressPolicy(
                retry=RetryPolicy(max_attempts=3, base_backoff_s=0.001,
                                  max_backoff_s=0.002, deadline_s=120.0),
                breaker=BreakerPolicy(failure_threshold=10_000)),
            transport=rt, clock=clock, sleep=clock.sleep,
            rng=random.Random(42), registry=reg)

    base = f"http://127.0.0.1:{glob.http_api.port}"

    def deliver(req):
        return urllib.request.urlopen(req, timeout=5)

    def mk_sender(registry):
        inner = HttpJsonForwarder(base, timeout_s=5.0, max_per_body=3,
                                  egress=mk_egress())
        journal = ForwardJournal(str(tmp_path), fsync="never")
        fwd = ResilientForwarder(inner, destination="chaos-global",
                                 sender_id="crash-sender", seq_start=1,
                                 journal=journal, registry=registry)
        return _mk_local(fwd), fwd

    schedules = [
        ["ok"],
        ["ack_lost", "timeout", "timeout"],
        [503, 503, 503],
        ["ok", "kill"],
        ["ok"],
        ["ok"],
    ]
    rng = np.random.default_rng(seed)
    local, fwd = mk_sender(reg)
    reg2 = None
    try:
        c = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for r, schedule in enumerate(schedules):
            rt.current = ScriptedTransport(schedule, clock,
                                           deliver=deliver)
            c.sendto(_round_lines(r, rng),
                     ("127.0.0.1", local.bound_port()))
            # each flush's self-metric drain resets the counter, so
            # every round waits for ITS datagram: >= 1 again
            deadline = time.time() + 10
            while local.packets_received < 1 and time.time() < deadline:
                time.sleep(0.005)
            assert local.packets_received >= 1, "datagram lost"
            assert local.drain(10.0)
            if r == 3:
                with pytest.raises(SimulatedKill):
                    local.flush_once(timestamp=1000 + r)
                # the kill left [r2, r3] parked in memory and r3's
                # write-ahead BEGIN in the journal
                assert len(fwd._entries) == 2
                _hard_kill_local(local)
                # a real SIGKILL releases the journal's process lock
                # with the fd; the in-process simulation must too
                kill_journal_lock(fwd._journal)
                reg2 = ResilienceRegistry()
                local, fwd = mk_sender(reg2)
            else:
                local.flush_once(timestamp=1000 + r)
            clock.advance(10.0)
        c.close()
        assert glob.drain(10.0)
        out = sorted(
            (m.name, tuple(m.tags), str(m.type), m.value)
            for m in glob.flush_once(timestamp=9999)
            if not m.name.startswith("veneur."))
        dups = reg.peek("import", "forward.duplicates_dropped")
        recovered = reg2.peek("chaos-global",
                              "durability.recovered_intervals")
        pending = fwd.pending_spill
    finally:
        local.stop()
        glob.stop()
    return out, dups, recovered, pending


def test_sender_kill_restart_bit_identical_to_oracle(tmp_path):
    """THE durability acceptance criterion: a sender hard-killed
    mid-replay-ladder recovers its ladder from the journal, resumes
    under the ORIGINAL envelopes (so the receiver drops the chunk that
    was ambiguously applied before the crash), and the global tier's
    flushed t-digest/HLL/counter state ends bit-identical to a
    zero-crash oracle, with recovered_intervals_total > 0."""
    faulty, dups, recovered, pending = _run_with_kill(tmp_path)
    oracle, oracle_dups, oracle_pending = _run([["ok"]] * 6)
    assert pending == 0 and oracle_pending == 0
    # the kill stranded THREE intervals: the two parked ones (r1's —
    # mid-replay when the kill hit — and r2's) plus r3's write-ahead
    assert recovered == 3
    assert dups > 0                # receiver dedupe caught the replay
    assert oracle_dups == 0
    assert faulty == oracle        # bit-identical, no approx
    names = {n for n, _t, _ty, _v in faulty}
    assert any(n.endswith(".50percentile") for n in names)
    assert "chaos.uniq" in names and "chaos.total" in names


def test_scrape_loop_races_storm_and_kill_restart(tmp_path):
    """A /debug/flush + /debug/fleet scrape loop
    hammers BOTH tiers while a seeded ack-loss storm and a hard
    sender kill-restart run underneath. Every response that arrives
    must be parseable JSON with the expected top-level shape, and the
    scraping must never stall the forward path: the storm completes
    with exact totals at the global."""
    import threading

    reg = ResilienceRegistry()
    glob, _gsink = _mk_global(reg)
    clock = FakeClock()
    rt = _RoundTransport()
    base = f"http://127.0.0.1:{glob.http_api.port}"

    def deliver(req):
        return urllib.request.urlopen(req, timeout=5)

    def mk_sender(registry):
        egress = Egress(
            "chaos-global",
            policy=EgressPolicy(
                retry=RetryPolicy(max_attempts=3, base_backoff_s=0.001,
                                  max_backoff_s=0.002, deadline_s=120.0),
                breaker=BreakerPolicy(failure_threshold=10_000)),
            transport=rt, clock=clock, sleep=clock.sleep,
            rng=random.Random(42), registry=registry)
        inner = HttpJsonForwarder(base, timeout_s=5.0, max_per_body=3,
                                  egress=egress)
        journal = ForwardJournal(str(tmp_path), fsync="never")
        fwd = ResilientForwarder(inner, destination="chaos-global",
                                 sender_id="scrape-sender", seq_start=1,
                                 journal=journal, registry=registry)
        cfg = read_config(text=_SERVER_YAML)
        cfg.statsd_listen_addresses = ["udp://127.0.0.1:0"]
        cfg.http_address = "127.0.0.1:0"      # scrape surface
        cfg.forward_address = "placeholder:1"
        srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[],
                     forwarder=fwd)
        srv.start()
        return srv, fwd

    local, fwd = mk_sender(reg)

    # -- the racing scraper: GETs both endpoints on both tiers until
    # stopped; connection errors during the kill window are expected
    # (the scraped process is "dead"), but every 200 body MUST parse
    # with the expected shape
    urls = {"local": f"http://127.0.0.1:{local.http_api.port}"}
    stop = threading.Event()
    scraped = {"n": 0, "bad": []}

    def scrape_loop():
        while not stop.is_set():
            for tier in ("local", "global"):
                root = base if tier == "global" else urls["local"]
                for path in ("/debug/flush", "/debug/fleet"):
                    try:
                        with urllib.request.urlopen(root + path,
                                                    timeout=5) as r:
                            body = json.loads(r.read())
                    except (OSError, urllib.error.URLError):
                        continue      # kill window / restart race
                    except Exception as e:    # unparseable = the bug
                        scraped["bad"].append((tier, path, repr(e)))
                        continue
                    want = ("flight_recorder"
                            if path == "/debug/flush" else "senders")
                    if want not in body:
                        scraped["bad"].append((tier, path, body))
                    scraped["n"] += 1
            time.sleep(0.002)

    scraper = threading.Thread(target=scrape_loop, daemon=True)
    scraper.start()

    schedules = [
        ["ok"],
        seeded_schedule(104, 8, p_fail=0.6, ambiguous=True),
        [503, 503, 503],                        # parks the interval
        ["ok", "kill"],                         # replay lands, then die
        ["ok"],                                 # recovered ladder ships
        ["ok"],
    ]
    rng = np.random.default_rng(7)
    reg2 = None
    try:
        c = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for r, schedule in enumerate(schedules):
            rt.current = ScriptedTransport(schedule, clock,
                                           deliver=deliver)
            c.sendto(_round_lines(r, rng),
                     ("127.0.0.1", local.bound_port()))
            deadline = time.time() + 10
            while local.packets_received < 1 and time.time() < deadline:
                time.sleep(0.005)
            assert local.packets_received >= 1, "datagram lost"
            assert local.drain(10.0)
            if r == 3:
                with pytest.raises(SimulatedKill):
                    local.flush_once(timestamp=1000 + r)
                _hard_kill_local(local)
                local.http_api.stop()
                kill_journal_lock(fwd._journal)
                reg2 = ResilienceRegistry()
                local, fwd = mk_sender(reg2)
                urls["local"] = \
                    f"http://127.0.0.1:{local.http_api.port}"
            else:
                local.flush_once(timestamp=1000 + r)
            clock.advance(10.0)
        c.close()
        assert glob.drain(10.0)
        out = {m.name: m.value
               for m in glob.flush_once(timestamp=9999)}
        # scraping never stalled the forward path: exact totals
        assert out["chaos.total"] == sum(range(1, 7))      # 21
        assert out["chaos.extra"] == 2 * 6
        assert fwd.pending_spill == 0
        assert reg2.peek("chaos-global",
                         "durability.recovered_intervals") > 0
        # the scraper genuinely raced the storm, and every response
        # that arrived was parseable with the right shape
        stop.set()
        scraper.join(10.0)
        assert scraped["n"] >= 20, scraped
        assert scraped["bad"] == []
    finally:
        stop.set()
        local.stop()
        glob.stop()


def _mk_durable_global(tmp_path):
    cfg = read_config(text=_SERVER_YAML)
    cfg.http_address = "127.0.0.1:0"
    cfg.is_global = True
    cfg.durability_enabled = True
    cfg.durability_dir = str(tmp_path)
    cfg.durability_fsync = "never"
    srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[])
    srv.start()
    return srv


def _post_import(port: int, body: list, sender: str, seq: int,
                 chunk: int = 0, count: int = 1) -> dict:
    headers = {"Content-Type": "application/json",
               "X-Veneur-Forward-Version": "jsonmetric-v1"}
    headers.update(envelope_headers(sender, seq, chunk, count))
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/import",
        data=json.dumps(body).encode(), headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=5) as resp:
        return json.loads(resp.read())


def test_receiver_kill_restart_drops_ancient_replays(tmp_path):
    """Receiver-side durability: the per-sender watermarks journaled at
    each flush boundary survive a hard kill, so a restarted global
    refuses a replay of an interval it already flushed downstream
    (the pre-durability behavior was to re-admit and double-count)."""
    body = [{"name": "wm.c", "type": "counter", "tags": [], "value": 3}]
    glob = _mk_durable_global(tmp_path)
    try:
        port = glob.http_api.port
        assert _post_import(port, body, "anc", 5) == {"imported": 1}
        assert glob.drain(10.0)
        # watermarks journal ONE TICK BEHIND (a mid-tick admission may
        # not be in this tick's flushed state): tick 1 captures the
        # snapshot, tick 2 makes it durable
        glob.flush_once(timestamp=1)
        glob.flush_once(timestamp=2)
    finally:
        # hard kill: listeners down, NO graceful journal close (only
        # the process locks drop, as a real SIGKILL would drop them —
        # the engine journal holds one too)
        glob._stop.set()
        glob.http_api.stop()
        kill_journal_lock(glob._dedupe_journal)
        kill_journal_lock(glob._engine_journal)
        for s in glob._sockets + glob._listen_socks:
            try:
                s.close()
            except OSError:
                pass
    glob2 = _mk_durable_global(tmp_path)
    try:
        port2 = glob2.http_api.port
        # the ancient replay (<= restored watermark) must dedupe...
        assert _post_import(port2, body, "anc", 5) == \
            {"imported": 0, "deduped": True}
        # ...while genuinely new intervals flow
        assert _post_import(port2, body, "anc", 6) == {"imported": 1}
    finally:
        glob2.stop()


def test_durability_disabled_default_is_inert(tmp_path, monkeypatch):
    """With durability off (the default config) the server builds no
    journals, the flush tick does zero journal work, and nothing
    touches the filesystem — the pre-durability behavior, regression-
    pinned."""
    monkeypatch.chdir(tmp_path)        # catch any stray relative writes
    cfg = read_config(text=_SERVER_YAML)
    cfg.forward_address = "placeholder:1"
    sent = []
    srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[],
                 forwarder=lambda export: sent.append(export))
    try:
        assert srv._forward_journal is None
        assert srv._dedupe_journal is None
        assert isinstance(srv.forwarder, ResilientForwarder)
        assert srv.forwarder._journal is None
        srv.start()
        srv.flush_once(timestamp=1)
        assert os.listdir(tmp_path) == []
    finally:
        srv.stop()


# =====================================================================
# Global-tier kill-restart chaos: the engine journal under a
# hard GLOBAL kill mid-interval, in a real two-tier UDP -> forward
# topology. The restarted global must flush state BIT-IDENTICAL to a
# zero-crash oracle AND keep deduping ancient replays.
# =====================================================================

def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mk_durable_global_fixed(tmp, port: int, reg: ResilienceRegistry):
    cfg = read_config(text=_SERVER_YAML)
    cfg.http_address = f"127.0.0.1:{port}"
    cfg.is_global = True
    cfg.durability_enabled = True
    cfg.durability_dir = str(tmp)
    cfg.durability_fsync = "never"
    srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[])
    # count duplicate drops into the test's registry WITHOUT replacing
    # the ledger — engine recovery re-seeded it with the admitted
    # envelopes, and discarding that state is exactly the double-count
    # bug this suite exists to catch
    srv.dedupe_ledger._registry = reg
    srv.start()
    return srv


def _hard_kill_global(srv):
    """SIGKILL simulation for the GLOBAL: listeners down, no graceful
    close — the journal locks drop with the fds, everything else the
    next incarnation must learn from the bytes on disk."""
    srv._stop.set()
    try:
        srv.http_api.stop()
    except Exception:
        pass
    kill_journal_lock(srv._engine_journal)
    kill_journal_lock(srv._dedupe_journal)
    for s in srv._sockets + srv._listen_socks:
        try:
            s.close()
        except OSError:
            pass


def _run_global_kill(tmp_path, kill: bool, seed: int = 7):
    """Drive the two-tier topology; the GLOBAL is hard-killed after
    admitting seq 3 MID-INTERVAL (its merged state exists only in the
    write-ahead engine journal — the prior flush boundary's checkpoint
    covers seqs 1-2) and restarts from the journal on the same port.

    Round script (seq = round + 1):
      r0  ok                      seq 1 admitted
      r1  ok                      seq 2 admitted
      --- global flush tick (delta checkpoint covers 1-2) ---
      r2  ok                      seq 3 admitted, NOT yet flushed
      r3  503,503,503             seq 4 parks at the sender
      --- [kill arm] hard-kill global; restart from journal ---
      r4  ack_lost, ok...         replay seq 4 (chunk applied at the
                                  RESTARTED global, ack lost, retry
                                  deduped) then seq 5
      r5  ok                      seq 6
    Returns (mid-flush rows, final rows, dup count, recovery stats).
    """
    reg = ResilienceRegistry()
    gport = _free_port()
    glob = _mk_durable_global_fixed(tmp_path, gport, reg)
    clock = FakeClock()
    rt = _RoundTransport()
    egress = Egress(
        "chaos-global",
        policy=EgressPolicy(
            retry=RetryPolicy(max_attempts=4, base_backoff_s=0.001,
                              max_backoff_s=0.002, deadline_s=120.0),
            breaker=BreakerPolicy(failure_threshold=10_000)),
        transport=rt, clock=clock, sleep=clock.sleep,
        rng=random.Random(42), registry=reg)
    base = f"http://127.0.0.1:{gport}"
    inner = HttpJsonForwarder(base, timeout_s=5.0, max_per_body=3,
                              egress=egress)

    def deliver(req):
        return urllib.request.urlopen(req, timeout=5)

    fwd = ResilientForwarder(inner, destination="chaos-global",
                             sender_id="gk-sender", seq_start=1,
                             registry=reg)
    local = _mk_local(fwd)
    schedules = [
        ["ok"],
        ["ok"],
        ["ok"],
        [503, 503, 503, 503],
        ["ack_lost", "ok"],
        ["ok"],
    ]
    rng = np.random.default_rng(seed)
    mid = None
    recovery = None
    try:
        c = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for r, schedule in enumerate(schedules):
            if r == 2:
                # the global's own flush boundary: the delta
                # checkpoint that makes seqs 1-2 part of a
                # self-contained snapshot group
                assert glob.drain(10.0)
                mid = sorted(
                    (m.name, tuple(m.tags), str(m.type), m.value)
                    for m in glob.flush_once(timestamp=500)
                    if not m.name.startswith("veneur."))
            if r == 4 and kill:
                _hard_kill_global(glob)
                glob = _mk_durable_global_fixed(tmp_path, gport, reg)
                recovery = glob._recovery
                # ancient replays still dedupe after restart: seq 3
                # was recovered from the write-ahead log, seq 1 from
                # the pre-checkpoint window — both must be refused
                for old_seq in (1, 3):
                    assert _post_import(
                        gport,
                        [{"name": "gk.probe", "type": "counter",
                          "tags": [], "value": 1}],
                        "gk-sender", old_seq, chunk=0, count=3) == \
                        {"imported": 0, "deduped": True}
            rt.current = ScriptedTransport(schedule, clock,
                                           deliver=deliver)
            c.sendto(_round_lines(r, rng),
                     ("127.0.0.1", local.bound_port()))
            deadline = time.time() + 10
            while local.packets_received < 1 and time.time() < deadline:
                time.sleep(0.005)
            assert local.packets_received >= 1, "datagram lost"
            assert local.drain(10.0)
            local.flush_once(timestamp=1000 + r)
            clock.advance(10.0)
        c.close()
        assert glob.drain(10.0)
        out = sorted(
            (m.name, tuple(m.tags), str(m.type), m.value)
            for m in glob.flush_once(timestamp=9999)
            if not m.name.startswith("veneur."))
        dups = reg.peek("import", "forward.duplicates_dropped")
        assert fwd.pending_spill == 0
    finally:
        local.stop()
        glob.stop()
    return mid, out, dups, recovery


def test_global_kill_restart_bit_identical_to_oracle(tmp_path):
    """The global tier's acceptance criterion: hard-kill the GLOBAL
    mid-interval under a real two-tier UDP -> forward topology,
    restart it from the engine journal, and its full flushed state —
    every t-digest percentile and aggregate, HLL set estimate, and
    counter sum — is BIT-IDENTICAL to a zero-crash oracle run over
    the same traffic and fault schedule, with ancient replays still
    deduped after the restart (asserted inside the run) and the
    recovered-op accounting visible."""
    mid_c, crash, dups, recovery = _run_global_kill(
        tmp_path / "crash", kill=True)
    mid_o, oracle, oracle_dups, _ = _run_global_kill(
        tmp_path / "oracle", kill=False)
    # recovery genuinely restored checkpoint state AND replayed the
    # write-ahead ops the checkpoint didn't cover
    assert recovery is not None
    assert recovery["engines_restored"] >= 1
    assert recovery["ops_replayed"] >= 1
    # the dedupe ledger fired at the RESTARTED global (the ack-lost
    # retry) — and the oracle saw the same schedule, so both count
    assert dups > 0 and oracle_dups > 0
    # the pre-kill flush boundary agreed too
    assert mid_c == mid_o
    # THE criterion: bit-identical, no approx
    assert crash == oracle
    names = {n for n, _t, _ty, _v in crash}
    assert any(n.endswith(".50percentile") for n in names)
    assert "chaos.uniq" in names and "chaos.total" in names


def test_ready_reports_recovering_and_debug_flush_checkpoint_block(
        tmp_path):
    """A durable global constructed (recovery ran
    in __init__) but not yet serving reports a structured `recovering`
    verdict on the readiness probe; once started, /ready flips and
    GET /debug/flush serves the checkpoint block (generation, bytes,
    dirty/total ratio, last-snapshot age, restore stats)."""
    glob = _mk_durable_global(tmp_path)
    glob.stop()
    glob2cfg = read_config(text=_SERVER_YAML)
    glob2cfg.http_address = "127.0.0.1:0"
    glob2cfg.is_global = True
    glob2cfg.durability_enabled = True
    glob2cfg.durability_dir = str(tmp_path)
    glob2cfg.durability_fsync = "never"
    glob2 = Server(glob2cfg, sinks=[CaptureMetricSink()], plugins=[])
    try:
        h = glob2.health_state()
        assert h["status"] == "recovering"
        assert h["ready"] is False
        assert h["checks"]["recovery"]["in_progress"] is True
        glob2.start()
        h2 = glob2.health_state()
        assert h2["ready"] is True
        assert h2["status"] == "ok"
        assert h2["checks"]["recovery"]["ok"] is True
        out = {m.name: m.value
               for m in glob2.flush_once(timestamp=1)}  # -> a checkpoint
        # veneur.durability.engine_* self-metrics are present-at-zero
        # while the feature is armed (a zero IS the steady-state
        # signal: armed, nothing degraded, nothing skipped)
        for name in (
                "veneur.durability.engine_delta_skipped_piles_total",
                "veneur.durability.engine_recovered_ops_total",
                "veneur.durability.engine_recovered_metrics_total",
                "veneur.durability.engine_snapshot_piles_dirty",
                "veneur.durability.engine_snapshot_piles_total",
                "veneur.durability.engine_snapshot_bytes",
                "veneur.durability.engine_restore_ns"):
            assert name in out, name
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{glob2.http_api.port}/debug/flush",
            timeout=5).read())
        blk = body["durability"]["engine_checkpoint"]
        assert blk["enabled"] is True
        for key in ("generation", "journal_bytes",
                    "last_snapshot_bytes", "piles_dirty",
                    "piles_total", "dirty_ratio",
                    "last_checkpoint_age_s", "restore"):
            assert key in blk, key
    finally:
        glob2.stop()


def test_torn_checkpoint_group_falls_back_to_previous(tmp_path):
    """A crash mid-append can leave one checkpoint group's META frame
    on disk without the KEYS/BANK rows (each record is its own CRC'd
    frame): recovery must NOT restore that partial group — its
    watermark would suppress the op replay that backs the missing
    rows, silently losing the interval. The group-commit marker makes
    recovery fall back to the previous COMMITTED group and replay the
    ops above its watermark instead."""
    from veneur_tpu_torch.durability import records as drec
    from veneur_tpu_torch.durability.journal import (HEADER_BYTES,
                                               decode_frames,
                                               encode_frame)
    body = [{"name": "tg.c", "type": "counter", "tags": [], "value": 5}]
    glob = _mk_durable_global(tmp_path)
    try:
        port = glob.http_api.port
        assert _post_import(port, body, "tg", 1) == {"imported": 1}
        assert glob.drain(10.0)
        glob.flush_once(timestamp=1)       # C1, committed
        assert _post_import(port, body, "tg", 2) == {"imported": 1}
        assert glob.drain(10.0)
        glob.flush_once(timestamp=2)       # C2 — torn below
    finally:
        glob._stop.set()
        glob.http_api.stop()
        kill_journal_lock(glob._dedupe_journal)
        kill_journal_lock(glob._engine_journal)
        for s in glob._sockets + glob._listen_socks:
            try:
                s.close()
            except OSError:
                pass
    # tear C2: drop the journal's FINAL frame (the group's COMMIT),
    # exactly what a kill between the group's appends leaves behind
    path = os.path.join(str(tmp_path), "engine.journal")
    blob = open(path, "rb").read()
    recs, _end, torn = decode_frames(blob, HEADER_BYTES)
    assert not torn and recs[-1][0] == drec.REC_ENGINE_COMMIT
    with open(path, "wb") as f:
        f.write(blob[:HEADER_BYTES])
        for rec_type, payload in recs[:-1]:
            f.write(encode_frame(rec_type, payload))
    glob2 = _mk_durable_global(tmp_path)
    try:
        # op 2 (above C1's watermark) replayed on top of C1's state...
        assert glob2._recovery["ops_replayed"] >= 1
        # ...its envelope still dedupes the sender's replay...
        assert _post_import(glob2.http_api.port, body, "tg", 2) == \
            {"imported": 0, "deduped": True}
        assert glob2.drain(10.0)
        out = {m.name: m.value
               for m in glob2.flush_once(timestamp=9)}
        # ...and its value is flushed once — not lost (the pre-fix
        # failure mode: partial restore suppressed the replay), not
        # doubled
        assert out.get("tg.c") == 5.0
    finally:
        glob2.stop()


# =====================================================================
# The port's durable surfaces: the gRPC import path, the config keys and
# the debug blocks held against the reference's.
# =====================================================================

_GRPC_WIDTHS = dict(tpu_histogram_slots=512, tpu_counter_slots=512,
                    tpu_gauge_slots=512, tpu_set_slots=256,
                    tpu_batch_size=256, tpu_buffer_depth=256,
                    tpu_hll_precision=10)


def _grpc_global(tmp, gport, **kw):
    from veneur_tpu_torch.config import Config
    cfg = Config(statsd_listen_addresses=[], interval="3600s",
                 hostname="g", aggregation_backend="cpu", num_workers=2,
                 grpc_listen_addresses=[f"127.0.0.1:{gport}"],
                 http_address="127.0.0.1:0", is_global=True,
                 durability_enabled=True, durability_dir=str(tmp),
                 durability_fsync="never", flush_phase_timers=False,
                 **{**_GRPC_WIDTHS, **kw})
    srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[])
    return srv


def _hard_kill_grpc_global(srv):
    """SIGKILL for the gRPC global: the import server and the HTTP
    listener drop at once, no drain, no journal close; the journal
    locks go with the fds."""
    srv._stop.set()
    for g in srv._grpc_servers:
        g.stop(None)
    srv.http_api.stop()
    kill_journal_lock(srv._engine_journal)
    kill_journal_lock(srv._dedupe_journal)


def _grpc_exports(seed, n_timers=40, n_sets=8):
    from veneur_tpu_torch.ingest.parser import MetricKey
    from veneur_tpu_torch.models.pipeline import ForwardExport
    rng = np.random.default_rng(seed)
    exp = ForwardExport()
    for k in range(n_timers):
        v = np.sort(rng.lognormal(3, 1, int(rng.integers(2, 60)))
                    .astype(np.float32))
        w = np.ones(v.size, np.float32)
        exp.histograms.append((MetricKey(f"gk.t{k}", "timer", ""), v, w,
                               float(v.min()), float(v.max()),
                               float(v.astype(np.float64).sum()),
                               float(v.size),
                               float((1.0 / v).astype(np.float64).sum())))
    for k in range(n_sets):
        exp.sets.append((MetricKey(f"gk.s{k}", "set", ""),
                         rng.integers(0, 20, 1 << 10).astype(np.uint8)))
    for k in range(20):
        exp.counters.append((MetricKey(f"gk.c{k}", "counter", ""),
                             float(rng.integers(1, 100))))
        exp.gauges.append((MetricKey(f"gk.g{k}", "gauge", ""),
                           float(rng.normal())))
    return exp


def _grpc_run(tmp, kill: bool):
    """Two locals' senders forward over gRPC (chunks of 16 metrics) into
    a durable 2-worker global with the history tier: interval 1 (two
    sends) is flushed, interval 2's sends are acked, then the global is
    hard-killed before its flush and restarted on the same port and
    durability_dir; interval 3's send, then the flush. Returns the two
    flushes' rows, the recovery stats and a /query answer."""
    from veneur_tpu_torch.cluster.forward import GrpcForwarder
    gport = _free_port()
    glob = _grpc_global(tmp, gport, history_retention_generations=3)
    glob.start()
    senders = [ResilientForwarder(
        GrpcForwarder(f"127.0.0.1:{gport}", max_per_batch=16,
                      engine_stamp=glob.engine_stamp),
        destination=f"gk-{j}", sender_id=f"gk-sender-{j}", seq_start=1)
        for j in range(2)]
    rows, recovery = [], None
    try:
        for r in range(3):
            if r == 2 and kill:
                _hard_kill_grpc_global(glob)
                glob = _grpc_global(tmp, gport,
                                    history_retention_generations=3)
                recovery = glob._recovery
                glob.start()
            for j, rf in enumerate(senders):
                rf(_grpc_exports(10 * r + j))
            assert glob.drain(30.0)
            if r != 1:
                rows.append(sorted(
                    (m.name, tuple(m.tags), str(m.type), m.value)
                    for m in glob.flush_once(timestamp=100 + 100 * r)
                    if not m.name.startswith("veneur.")))
        q = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{glob.http_api.port}/query?metric=gk.t3"
            "&q=count,max&t0=0&t1=301", timeout=30).read())
        assert all(rf.pending_spill == 0 for rf in senders)
    finally:
        for rf in senders:
            rf.close()
        glob.stop()
    return rows, recovery, q


def test_grpc_global_kill_restart_bit_identical_to_twin(tmp_path):
    """The gRPC import path writes ahead through _submit_import_batch:
    a global killed after acking interval 2 and restarted on the same
    durability_dir restores its checkpoint, replays the ops above the
    watermark, and flushes bit for bit what its uncrashed twin does;
    the history tier answers across the restart."""
    crash, recovery, qc = _grpc_run(tmp_path / "crash", kill=True)
    twin, _none, qt = _grpc_run(tmp_path / "twin", kill=False)
    assert recovery["engines_restored"] == 2
    assert recovery["ops_replayed"] >= 1
    assert recovery["metrics_replayed"] > 0
    assert crash[0] == twin[0]
    assert crash[1] == twin[1]           # bit for bit, no approx
    assert any(n.endswith(".50percentile") for n, *_ in crash[1])
    assert qc["results"] == qt["results"]
    assert qc["generations"]["count"] == 2


def test_grpc_imports_are_journaled_write_ahead(tmp_path):
    """With engine checkpointing armed the import server hands whole
    requests to _submit_import_batch: each admitted RPC is one
    ENGINE_IMPORT record in the journal before the worker applies it."""
    from veneur_tpu_torch.cluster.forward import GrpcForwarder
    from veneur_tpu_torch.durability import records as drec
    gport = _free_port()
    glob = _grpc_global(tmp_path, gport)
    glob.start()
    rf = ResilientForwarder(
        GrpcForwarder(f"127.0.0.1:{gport}", max_per_batch=16,
                      engine_stamp=glob.engine_stamp),
        destination="wa", sender_id="wa", seq_start=1)
    try:
        exp = _grpc_exports(1)
        rf(exp)
        assert glob.drain(30.0)
        n = len(exp.histograms) + len(exp.sets) + len(exp.counters) \
            + len(exp.gauges)
        # the ops written ahead, as the server retains them for the
        # next compaction
        ops = list(glob._recent_import_ops)
        assert len(ops) == -(-n // 16)       # one op per RPC chunk
        envs = [drec.decode_engine_import(p)[2] for _i, p in ops]
        assert [e[:2] for e in envs] == [("wa", 1)] * len(ops)
        assert sum(len(drec.decode_engine_import(p)[1])
                   for _i, p in ops) == n
        assert all(e.last_import_op > 0 for e in glob.engines)
    finally:
        rf.close()
        glob.stop()


def test_refused_keys_lost_exactly_the_durability_rows():
    from veneur_tpu_torch import server as tserver
    keys = [k for k, _f, _i in tserver.REFUSED_KEYS]
    assert "durability_enabled" not in keys
    assert "history_retention_generations" not in keys
    assert not any("item 11" in item for _k, _f, item in
                   tserver.REFUSED_KEYS)
    # native_ingest (item 13), the network sinks (item 9b.2), several
    # devices (item 14) and the fetch modes (item 16) are served too:
    # nothing is left
    assert len(keys) == 0


def test_durable_keys_build_the_journals(tmp_path):
    """durability_enabled and history_retention_generations are served:
    a forwarding global gets the forward journal, the watermark journal,
    the engine journal, the history store and the query tier, all in its
    durability_dir, and stop() releases them for the next incarnation."""
    cfg = read_config(text=_SERVER_YAML)
    cfg.http_address = "127.0.0.1:0"
    cfg.is_global = True
    cfg.forward_address = "127.0.0.1:1"
    cfg.durability_enabled = True
    cfg.durability_dir = str(tmp_path)
    cfg.history_retention_generations = 2
    srv = Server(cfg, sinks=[CaptureMetricSink()], plugins=[])
    try:
        assert srv.forwarder._journal is srv._forward_journal
        assert srv._dedupe_journal is not None
        assert srv._engine_journal is not None
        assert srv._query_tier is not None and srv._history is not None
        assert all(e._dirty is not None for e in srv.engines)
        assert {"forward.journal", "dedupe.journal",
                "engine.journal"} <= set(os.listdir(tmp_path))
    finally:
        srv.stop()
    again = Server(cfg, sinks=[CaptureMetricSink()], plugins=[])
    again.stop()


def test_engine_journal_failure_degrades_loudly(tmp_path, monkeypatch):
    """A failing disk under the engine journal disables checkpointing,
    counted, and the imports still land: the in-memory contract."""
    from veneur_tpu_torch import resilience as tres
    glob = _mk_durable_global(tmp_path)
    try:
        before = tres.DEFAULT_REGISTRY.total(
            "import", "durability.journal_errors")

        def boom(*a, **k):
            raise OSError(28, "No space left on device")
        monkeypatch.setattr(glob._engine_journal, "append_import", boom)
        body = [{"name": "dg.c", "type": "counter", "tags": [],
                 "value": 4}]
        assert _post_import(glob.http_api.port, body, "dg", 1) == \
            {"imported": 1}
        assert glob.drain(10.0)
        out = {m.name: m.value for m in glob.flush_once(timestamp=3)}
        assert out["dg.c"] == 4.0
        assert glob._engine_journal is None
        assert tres.DEFAULT_REGISTRY.total(
            "import", "durability.journal_errors") == before + 1
        h = glob.health_state()
        assert h["checks"]["journal"]["degraded"] == ["engine"]
        assert h["status"] == "degraded" and h["healthy"]
    finally:
        glob.stop()


def test_durable_debug_blocks_have_the_references_keys(tmp_path):
    """A durable reference global and a durable port global: the
    /debug/flush durability and query blocks, the checkpoint block and
    the /ready checks carry the same keys."""
    from veneur_tpu.config import read_config as jread_config
    from veneur_tpu.server import Server as JServer
    from veneur_tpu.sinks.basic import CaptureMetricSink as JCapture
    body = [{"name": "kb.c", "type": "counter", "tags": [], "value": 1}]
    states = []
    for name, read, S, Cap in (("ref", jread_config, JServer, JCapture),
                               ("port", read_config, Server,
                                CaptureMetricSink)):
        text = _SERVER_YAML if name == "port" else \
            _SERVER_YAML.replace("aggregation_backend: cpu\n", "")
        cfg = read(text=text)
        cfg.http_address = "127.0.0.1:0"
        cfg.is_global = True
        cfg.durability_enabled = True
        cfg.durability_dir = str(tmp_path / name)
        cfg.durability_fsync = "never"
        cfg.history_retention_generations = 2
        srv = S(cfg, sinks=[Cap()], plugins=[])
        srv.start()
        try:
            port = srv.http_api.port
            assert _post_import(port, body, "kb", 1) == {"imported": 1}
            assert srv.drain(30.0)
            srv.flush_once(timestamp=10)
            dbg = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/flush", timeout=10).read())
            ready = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/ready", timeout=10).read())
            states.append((dbg, ready))
        finally:
            srv.stop()
    (jd, jr), (td, tr) = states
    assert set(td["durability"]) == set(jd["durability"])
    for blk in ("engine_checkpoint", "history"):
        assert set(td["durability"][blk]) == set(jd["durability"][blk])
    assert set(td["durability"]["engine_checkpoint"]["restore"]) == \
        set(jd["durability"]["engine_checkpoint"]["restore"])
    assert set(td["query"]) == set(jd["query"])
    assert set(tr["checks"]) == set(jr["checks"])
    for c in ("journal", "recovery"):
        assert set(tr["checks"][c]) == set(jr["checks"][c])
    assert tr["ready"] and tr["status"] == jr["status"] == "ok"
    assert td["durability"]["history"]["generations"] == \
        jd["durability"]["history"]["generations"] == 1
