"""A DogStatsD local: the port's Server with one UDP statsd listener,
fed by the sender processes of a `statsd` traffic mix.

Set-up starts the senders (they build their pools from the seed while
the Server starts), then the Server; the senders send their prelude
(every key once), which the harness waits to see landed and flushes;
then the load starts, and the harness flushes `warm_flushes` times at
the cell's key space, the last of them opening the window. The window
then calls `Server.flush_once` every interval, in place of the server's
own ticker (whose interval is set past the run), and times each call;
it counts the samples its flushes' rows hold. After the window the senders stop,
the harness waits until the port has taken and landed all they sent,
flushes once more, and the reference judges every flush's rows.
"""

from __future__ import annotations

import gc
import time

from ..gen import statsd as gen
from ..reference import local as ref
from . import common


def settle(srv, dgrams: int, base: int, timeout: float = 60.0) -> bool:
    """Wait until the port has taken `dgrams` datagrams since `base`
    and landed every sample staged. False when the time runs out (a
    datagram lost on the way never comes)."""
    deadline = time.monotonic() + timeout
    if srv.native_bridge is None:
        time.sleep(0.5)
        return srv.drain(timeout)
    bridge, pump = srv.native_bridge, srv.native_pump
    while time.monotonic() < deadline:
        st = bridge.stats()
        if st["packets"] - base >= dgrams \
                and st["samples"] - st["ring_drops"] == pump.landed:
            return srv.drain(max(1.0, deadline - time.monotonic()))
        time.sleep(0.01)
    return False


def samples_in(flush: dict, every: int) -> int:
    """The timer and counter samples one flush's rows hold: the
    histograms' counts, and each counter's sum over its lines' weight
    (every increment is 1). Gauge and set rows carry no count."""
    n = 0.0
    if ref.HISTO in flush:
        n += float(flush[ref.HISTO][1][:, -1].sum())
    if ref.COUNTER in flush:
        keys, sums = flush[ref.COUNTER]
        n += float((sums / ref.weights(keys, every)).sum())
    return int(round(n))


def cpu_note(cpu: dict, window_s: float) -> str:
    """The window's CPU in cores: the pump thread, the flush calls and
    the rest of the port's process."""
    pump = cpu.get("pump_s")
    rest = cpu["window_s"] - cpu["flush_s"] - (pump or 0.0)
    return ("CPU over the window, cores: pump "
            + ("not read" if pump is None else f"{pump / window_s:.4f}")
            + f", flush calls {cpu['flush_s'] / window_s:.4f}, the rest "
            f"{rest / window_s:.4f}; in all {cpu['window_s'] / window_s:.4f}"
            f" (process {cpu['process_s'] / window_s:.4f}, the harness's "
            f"thread {cpu['main_s'] / window_s:.4f})")


def prepare(cell: dict, args) -> dict:
    """What set-up needs before the port: the senders' pools and shares,
    and the sender processes, started so that they build their pools
    while the harness imports torch and starts the Server."""
    traffic = cell["traffic"]
    interval = float(cell["config"]["interval_s"])
    n_warm = int(cell["config"].get("warm_flushes", 2))
    span = (args.seconds + (n_warm + 1) * interval
            + float(traffic["margin_s"]))
    rate = float(traffic["rate_lines_per_s"])
    pools = gen.pool_lines(traffic, args.seed, int(rate * span))
    specs = [{"traffic": traffic, "seed": args.seed, "sender": s,
              "pool_lines": pools[s]} for s in range(len(pools))]
    return {"pools": pools, "shares": gen.sender_shares(traffic, args.seed),
            "procs": common.Procs("portbench.gen." + traffic["generator"],
                                  specs),
            "started": time.monotonic() - args.process_start}


def run(cell: dict, args, device, prep=None) -> dict:
    """One run; `prep` is what `prepare` returned, or None to prepare
    here."""
    phases = {}

    def stamp(name):
        phases[name] = time.monotonic() - args.process_start

    if prep is None:
        prep = prepare(cell, args)
    phases["generators_started"] = prep["started"]
    stamp("torch_ready")
    conf, traffic = cell["config"], cell["traffic"]
    interval = float(conf["interval_s"])
    seed = args.seed
    n_send = int(traffic["senders"])
    L = int(traffic["lines_per_datagram"])
    n_warm = int(conf.get("warm_flushes", 2))
    rate = float(traffic["rate_lines_per_s"])
    pools, shares, procs = prep["pools"], prep["shares"], prep["procs"]
    srv = recorders = None
    try:
        from veneur_tpu_torch.config import Config
        from veneur_tpu_torch.server import Server

        server_kw = dict(conf["server"])
        # the harness flushes every interval itself; the ticker stays idle
        server_kw["interval"] = "86400s"
        server_kw["statsd_listen_addresses"] = ["udp://127.0.0.1:0"]
        cfg = Config(**server_kw)
        qs = tuple(cfg.percentiles)
        stamp("port_imported")
        srv = Server(cfg, sinks=[], device=device)
        srv.start()
        stamp("server_started")
        # the engine's first flush computes its baseline rows; take it
        # before any traffic, so that no sample waits on it
        srv.flush_once()
        stamp("baseline_flushed")
        procs.reports(300.0)
        stamp("generators_ready")
        base = (srv.native_bridge.stats()["packets"]
                if srv.native_bridge is not None else 0)
        # the prelude: every key lands once and is flushed before the
        # load starts, so that no first use of a key or of a flush at
        # the cell's key space falls under the load
        procs.tell([{"port": srv.bound_port()} for _ in procs.procs])
        primed = [r["primed"] for r in procs.reports()]
        primed_ok = settle(srv, sum(primed) // L, base)
        codes = common.NameCodes()
        rows = [common.read_frameset(srv.flush_once(), codes, qs,
                                     common.SELF)[0]]
        stamp("prelude_flushed")
        recorders = common.Recorders(device, bool(args.trace))
        recorders.start()
        stamp("recorders_started")
        t_go = time.monotonic() + 0.05
        procs.tell([{"t0": t_go, "rate": rate * shares[s]}
                    for s in range(n_send)])
        probe = (None if srv.native_bridge is None else
                 lambda: srv.native_bridge.stats()["packets"] - base)
        warm_rows, warm_probes = common.warm(srv, t_go, interval, n_warm,
                                             codes, qs, probe)
        rows += warm_rows
        stamp("warm_flushed")
        threads = ({} if srv.native_pump is None else
                   {"pump": srv.native_pump._thread.native_id})
        win = common.window(srv, conf, args, codes, qs, "pump",
                            procs.stop, recorders,
                            t_go + n_warm * interval, probe=probe,
                            threads=threads)
        reports = win["reports"]
        sent = [r["lines"] for r in reports]
        settled = settle(srv, sum(sent) // L, base)
        bridge = (srv.native_bridge.stats() if srv.native_bridge is not None
                  else {})
        final = srv.flush_once()
        last = common.read_frameset(final, codes, qs, common.SELF)[0]
        bad_tags = common.check_tags(final, codes)
        del final
        peak = common.device_peak(device)
    finally:
        procs.close()
        if recorders is not None:
            recorders.stop()
        if srv is not None:
            srv.stop()
    del srv
    gc.collect()
    phases["window"] = win["t_w0"] - args.process_start

    # the reference, once the window has closed and the port is stopped
    flushes = [common.by_kind(b) for b in rows + win["rows"] + [last]]
    verdict = ref.judge(ref.Sent(traffic, seed, pools, sent), flushes, qs,
                        cfg.tpu_compression, cfg.tpu_hll_precision, seed)
    verdict["checks"]["tags_off"] = [bad_tags, 0]
    verdict["checks"]["unsettled"] = [0 if settled and primed_ok else 1, 0]
    verdict["correct"] = all(v <= lim for v, lim
                             in verdict["checks"].values())
    attempted = sum(common.lines_between(r["timeline"], win["t_w0"],
                                         win["t_w1"]) for r in reports)
    rec = common.record("local", conf, args, win, phases, verdict, peak,
                        attempted)
    every = int(traffic["mix"].get("counter", {}).get("sampled_every", 0))
    rec["flush_samples"] = [samples_in(f, every) for f in flushes[
        len(rows) + 1:len(rows) + len(win["rows"])]]
    rec["max_lag_s"] = max(r["max_lag_s"] for r in reports)
    rec["notes"].append(cpu_note(rec["cpu"], rec["window_s"]))
    rec["notes"].append(
        "set-up phases, s from the process's start: " + ", ".join(
            f"{k} {v:.3f}" for k, v in phases.items()))
    rec["notes"].append(
        f"senders: most behind {rec['max_lag_s']:.4f} s, schedule moved "
        f"on {sum(r.get('held_s', 0.0) for r in reports):.4f} s")
    if bridge:
        rec["bridge"] = {"datagrams_sent": sum(sent) // L,
                         "datagrams_taken": bridge["packets"] - base,
                         "ring_drops": bridge["ring_drops"],
                         "drops_no_slot": bridge["drops_no_slot"]}
        if rec["failed"]:
            rec["notes"].append(f"bridge: {rec['bridge']}")

            # datagrams sent and not yet taken after each warm flush and
            # each of the window's: where the backlog passed the buffer
            def behind(taken, at):
                return int(sum(common.lines_between(r["timeline"], t_go, at)
                               for r in reports) / L - taken)

            rec["notes"].append(
                f"prelude settled: {primed_ok}; "
                "datagrams in flight after each warm flush: "
                + str([behind(n, at) for n, at in warm_probes])
                + "; after each window flush: "
                + str([behind(f["probe"], f["probe_at"])
                       for f in win["flushes"]]))
    rec["sent_lines"] = sum(sent)
    return rec
