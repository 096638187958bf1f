"""Mixed fleets: the port's tiers interoperate with the reference's.

One reference local and one port local take the same DogStatsD traffic
(under the name prefixes `r.` and `p.`) and forward each interval to a
reference global AND a port global, the `grpc.*` keys over gRPC and the
`http.*` keys over HTTP POST /import — each leg through its own
package's leaf forwarder wrapped in its own ResilientForwarder
(exactly-once envelopes, a sender id each). So every global receives
both packages' forwards in one run:

  reference global, `r.` rows   reference -> reference  (the baseline)
  reference global, `p.` rows   port      -> reference
  port global,      `r.` rows   reference -> port
  port global,      `p.` rows   port      -> port

Each receiving global's rows are held to the reference-to-reference
rows under the comparison contract (ROADMAP): counts, min, max,
counters and gauges exact; percentiles within 1% of each key's spread;
timer sums within rtol 1e-6 (float32 sums, which the port accumulates
per batch in float64: ROADMAP C.2); set estimates within rtol 1e-5 (the
HLL register files merge exactly; the estimate's exp2 differs by
ulps). Local-only timers never leave
their local. A mismatched centroid codec is refused before decode by
both packages' globals, on both transports. Two reference Servers start
in this file (each compiles its JAX programs); the port runs on the CPU.
"""

import socket
import time

import numpy as np
import pytest

from veneur_tpu import resilience as jres
from veneur_tpu import sketches as jsketches
from veneur_tpu.cluster import forward as jforward
from veneur_tpu.config import read_config as jread_config
from veneur_tpu.models.pipeline import ForwardExport as JExport
from veneur_tpu.server import Server as JServer
from veneur_tpu.sinks.basic import CaptureMetricSink as JCapture
from veneur_tpu_torch import resilience as tres
from veneur_tpu_torch import sketches as tsketches
from veneur_tpu_torch.cluster import forward as tforward
from veneur_tpu_torch.config import read_config
from veneur_tpu_torch.models.pipeline import ForwardExport as TExport
from veneur_tpu_torch.server import Server
from veneur_tpu_torch.sinks.basic import CaptureMetricSink

_YAML = """
interval: "3600s"
num_workers: 1
percentiles: [0.5, 0.9, 0.99]
aggregates: ["min", "max", "count", "sum"]
hostname: h
forward_delta: false
tpu_histogram_slots: 512
tpu_counter_slots: 512
tpu_gauge_slots: 512
tpu_set_slots: 128
tpu_batch_size: 512
tpu_buffer_depth: 256
"""

TRANSPORTS = ("grpc", "http")
INTERVALS = 2


class _SplitForwarder:
    """One local's forwarder: each interval's export is split by the
    key's transport prefix and each share goes to every global over that
    transport, each leg through its own ResilientForwarder."""

    def __init__(self, export_cls, legs):
        self.export_cls = export_cls
        self.legs = legs          # [(transport, ResilientForwarder)]

    def __call__(self, export):
        for transport, rf in self.legs:
            def mine(key, t=transport):
                return key.name.startswith(t + ".")
            sub = self.export_cls(set_engine=export.set_engine,
                                  kind=export.kind)
            sub.histograms = [h for h in export.histograms if mine(h[0])]
            sub.sets = [s for s in export.sets if mine(s[0])]
            sub.counters = [c for c in export.counters if mine(c[0])]
            sub.gauges = [g for g in export.gauges if mine(g[0])]
            rf(sub)

    def close(self):
        for _t, rf in self.legs:
            rf.close()


def _legs(res, fwd_mod, src, globals_, codec="lossless", stamp=None):
    legs = []
    for gname, grpc_port, http_port in globals_:
        for transport in TRANSPORTS:
            if transport == "grpc":
                leaf = fwd_mod.GrpcForwarder(
                    f"127.0.0.1:{grpc_port}", timeout_s=10.0,
                    engine_stamp=stamp, centroid_codec=codec)
            else:
                leaf = fwd_mod.HttpJsonForwarder(
                    f"http://127.0.0.1:{http_port}", timeout_s=10.0,
                    engine_stamp=stamp, centroid_codec=codec)
            legs.append((transport, res.ResilientForwarder(
                leaf, destination=f"{src}-{gname}-{transport}",
                sender_id=f"{src}-{gname}-{transport}", seq_start=1,
                registry=res.ResilienceRegistry())))
    return legs


def _traffic(seed: int):
    """INTERVALS intervals of lines (without the sender prefix) and the
    numpy truth per key."""
    rng = np.random.default_rng(seed)
    intervals, samples = [], {}
    for r in range(INTERVALS):
        lines = []
        for t in TRANSPORTS:
            for k in range(6):
                name = f"{t}.lat{k}"
                vals = [f"{v:.4f}" for v in rng.lognormal(3 + 0.3 * k,
                                                             0.6, 60)]
                samples.setdefault(name, []).extend(map(float, vals))
                lines += [f"{name}:{v}|ms" for v in vals]
            for k in range(4):
                lines += [f"{t}.hits{k}:{int(rng.integers(1, 20))}|c"
                          f"|#veneurglobalonly" for _ in range(5)]
                lines.append(f"{t}.temp{k}:{rng.normal(20, 4):.3f}|g"
                             f"|#veneurglobalonly")
            for k in range(3):
                lines += [f"{t}.users{k}:u{r}-{m}|s" for m in range(
                    int(rng.integers(20, 120)))]
            lines += [f"{t}.own:{v:.3f}|ms|#veneurlocalonly"
                      for v in rng.normal(5, 1, 10)]
        intervals.append(lines)
    return intervals, samples


def _send(srv, lines):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for i in range(0, len(lines), 40):
            s.sendto("\n".join(lines[i:i + 40]).encode(),
                     ("127.0.0.1", srv.bound_port()))
    want = -(-len(lines) // 40)
    deadline = time.monotonic() + 30
    while srv.packets_received < want and time.monotonic() < deadline:
        time.sleep(0.005)
    assert srv.packets_received == want, "datagrams lost"
    assert srv.drain(30.0)


def _rows(frameset, src):
    """{row name without the sender prefix: value} for one sender."""
    out = {}
    for m in frameset:
        parts = m.name.split(".", 2)
        if len(parts) == 3 and parts[1] == src and \
                parts[0] in TRANSPORTS:
            out[f"{parts[0]}.{parts[2]}"] = m.value
    return out


@pytest.fixture(scope="module")
def fleet():
    """Run the mixed fleet; yield each global's rows per interval."""
    jcfg = jread_config(text=_YAML)
    jcfg.grpc_listen_addresses = ["127.0.0.1:0"]
    jcfg.http_address = "127.0.0.1:0"
    jcfg.is_global = True
    jglob = JServer(jcfg, sinks=[JCapture()], plugins=[])
    tcfg = read_config(text=_YAML)
    tcfg.grpc_listen_addresses = ["127.0.0.1:0"]
    tcfg.http_address = "127.0.0.1:0"
    tcfg.is_global = True
    tglob = Server(tcfg, sinks=[CaptureMetricSink()], plugins=[],
                   device="cpu")
    started = []
    try:
        for g in (jglob, tglob):
            g.start()
            started.append(g)
        globals_ = [("jglob", jglob.grpc_port, jglob.http_api.port),
                    ("tglob", tglob.grpc_port, tglob.http_api.port)]
        jl = jread_config(text=_YAML)
        jl.statsd_listen_addresses = ["udp://127.0.0.1:0"]
        jl.forward_address = "placeholder:1"   # turns forward exports on
        jlocal = JServer(jl, sinks=[JCapture()], plugins=[],
                         forwarder=_SplitForwarder(JExport, _legs(
                             jres, jforward, "r", globals_)))
        tl = read_config(text=_YAML)
        tl.statsd_listen_addresses = ["udp://127.0.0.1:0"]
        tl.forward_address = "placeholder:1"
        tlocal = Server(tl, sinks=[CaptureMetricSink()], plugins=[],
                        device="cpu", forwarder=_SplitForwarder(
                            TExport, _legs(tres, tforward, "p", globals_)))
        for loc in (jlocal, tlocal):
            loc.start()
            started.append(loc)
        intervals, samples = _traffic(seed=11)
        rows = []
        for r, lines in enumerate(intervals):
            ts = 1000 + 10 * r
            for loc, src in ((jlocal, "r"), (tlocal, "p")):
                _send(loc, [ln.replace(".", f".{src}.", 1) for ln in lines])
                loc.flush_once(timestamp=ts)
                assert loc.forwarder.pending_spill == 0
            got = {}
            for name, g in (("jglob", jglob), ("tglob", tglob)):
                assert g.drain(30.0)
                got[name] = list(g.flush_once(timestamp=ts))
            rows.append(got)
        yield {"rows": rows, "samples": samples, "jglob": jglob,
               "tglob": tglob, "jlocal": jlocal, "tlocal": tlocal}
    finally:
        for s in reversed(started):
            s.stop()


def _assert_contract(got: dict, want: dict, samples: dict):
    assert set(got) == set(want)
    for name, v in want.items():
        key = name.rsplit(".", 1)[0]
        if name.endswith("percentile"):
            vals = np.asarray(samples[key])
            spread = float(vals.max() - vals.min())
            assert abs(got[name] - v) <= 0.01 * spread, name
        elif ".users" in name:
            assert got[name] == pytest.approx(v, rel=1e-5), name
        elif name.endswith(".sum"):
            assert got[name] == pytest.approx(v, rel=1e-6), name
        else:
            assert got[name] == v, name


@pytest.mark.parametrize("interval", range(INTERVALS))
@pytest.mark.parametrize("direction", ["reference->port", "port->reference",
                                       "port->port"])
def test_receiving_global_matches_the_reference_fleet(fleet, direction,
                                                      interval):
    """Each receiving global's rows against the reference-to-reference
    rows, both transports, under the comparison contract."""
    rows = fleet["rows"][interval]
    base = _rows(rows["jglob"], "r")
    glob, src = {"reference->port": ("tglob", "r"),
                 "port->reference": ("jglob", "p"),
                 "port->port": ("tglob", "p")}[direction]
    got = _rows(rows[glob], src)
    _assert_contract(got, base, fleet["samples"])
    for t in TRANSPORTS:
        assert f"{t}.lat0.99percentile" in got
        assert f"{t}.hits0" in got and f"{t}.temp0" in got
        assert f"{t}.users0" in got
        # local-only rows never leave their local
        assert not any(n.startswith(f"{t}.own") for n in got)


def test_truth_of_the_reference_fleet(fleet):
    """The baseline itself against numpy: counts, min, max and sums of
    the forwarded timers over both intervals' samples."""
    rows = fleet["rows"]
    for t in TRANSPORTS:
        for k in range(6):
            key = f"{t}.lat{k}"
            vals = np.asarray(fleet["samples"][key])
            per = [_rows(r["jglob"], "r") for r in rows]
            assert sum(p[f"{key}.count"] for p in per) == len(vals)
            assert min(p[f"{key}.min"] for p in per) == \
                float(np.float32(vals.min()))
            assert max(p[f"{key}.max"] for p in per) == \
                float(np.float32(vals.max()))


def test_every_leg_delivered_exactly_once(fleet):
    """Each global's ledger saw each (sender, transport) leg, one
    interval seq per flush, and nothing was parked."""
    for name in ("jglob", "tglob"):
        marks = fleet[name].dedupe_ledger.max_admitted()
        for src in ("r", "p"):
            for t in TRANSPORTS:
                assert marks[f"{src}-{name}-{t}"] == INTERVALS
    for loc in ("jlocal", "tlocal"):
        for _t, rf in fleet[loc].forwarder.inner.legs:
            assert rf.pending_spill == 0


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("sender,receiver", [("reference", "port"),
                                             ("port", "reference")])
def test_mismatched_codec_refused_by_both(fleet, transport, sender,
                                          receiver):
    """A q16 sender against a lossless global of the other package is
    refused before decode (gRPC FAILED_PRECONDITION / HTTP 400) and
    nothing lands."""
    pkg = {"reference": (jres, jforward, jsketches, JExport),
           "port": (tres, tforward, tsketches, TExport)}[sender]
    res, fwd_mod, sk, export_cls = pkg
    glob = fleet["tglob" if receiver == "port" else "jglob"]
    stamp = sk.stamp_with_codec(sk.DEFAULT_STAMP, "q16")
    pol = res.EgressPolicy(retry=res.RetryPolicy(max_attempts=1))
    if transport == "grpc":
        leaf = fwd_mod.GrpcForwarder(f"127.0.0.1:{glob.grpc_port}",
                                     engine_stamp=stamp,
                                     centroid_codec="q16",
                                     egress_policy=pol)
    else:
        leaf = fwd_mod.HttpJsonForwarder(
            f"http://127.0.0.1:{glob.http_api.port}", engine_stamp=stamp,
            centroid_codec="q16", egress_policy=pol)
    from veneur_tpu_torch.ingest.parser import MetricKey as TKey

    from veneur_tpu.ingest.parser import MetricKey as JKey
    key_cls = JKey if sender == "reference" else TKey
    exp = export_cls()
    exp.histograms.append((key_cls(f"mx.{transport}.t", "timer", ""),
                           np.float32([1.0, 2.0]), np.float32([1.0, 1.0]),
                           1.0, 2.0, 3.0, 2.0, 1.5))
    # the mismatch counter lives in each package's PROCESS registry;
    # this test's contribution is compensated afterwards so suites that
    # assert a pristine mismatch count stay order-independent
    regs = (jres.DEFAULT_REGISTRY, tres.DEFAULT_REGISTRY)
    before = [r.total("import", "import.engine_mismatch") for r in regs]
    try:
        with pytest.raises(Exception) as e:
            leaf(exp)
        text = str(e.value)
        assert ("FAILED_PRECONDITION" in text or "400" in text), text
        after = [r.total("import", "import.engine_mismatch")
                 for r in regs]
        # counted once, by the receiving package
        assert sum(after) - sum(before) == 1
        assert glob.drain(10.0)
        names = {m.name for m in glob.flush_once(timestamp=99999)}
        assert not any(n.startswith("mx.") for n in names)
    finally:
        for r, b in zip(regs, before):
            extra = r.total("import", "import.engine_mismatch") - b
            if extra:
                r.incr("import", "import.engine_mismatch", -extra)
        close = getattr(leaf, "close", None)
        if close is not None:
            close()
