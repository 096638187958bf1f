"""The reference against rows worked out by hand, and each of its
checks against a row put wrong."""

import numpy as np
import pytest

from portbench.gen import statsd as sgen
from portbench.reference import local as lref

QS = (0.5, 0.75, 0.99)
TRAFFIC = {"generator": "statsd", "senders": 2, "lines_per_datagram": 10,
           "max_datagram_bytes": 1432,
           "mix": {"timer": {"keys": 12, "share": 60, "zipf": 1.0},
                   "counter": {"keys": 6, "share": 20, "zipf": 1.0,
                               "sampled_every": 5},
                   "gauge": {"keys": 5, "share": 10, "zipf": 1.0},
                   "set": {"keys": 4, "share": 10, "zipf": 1.0}}}


@pytest.mark.parametrize("n", [1, 2, 3, 5, 10, 57, 400])
def test_an_exact_hazen_quantile_reads_rank_error_zero(n):
    x = np.random.default_rng(n).lognormal(3, 1, n).astype(np.float32)
    x[: n // 3] = x[0]                       # ties too
    got = np.quantile(x.astype(np.float64), QS, method="hazen")
    assert lref.rank_error(x, got, QS).max() < 1e-5
    assert lref.rank_error(x, got * 1.5, QS).max() > 0.0


def hand_rows(sent, cuts=2):
    """Each key's samples in `cuts` runs: its rows worked out directly."""
    flushes = [dict() for _ in range(cuts)]
    for kind, d in sent.kinds.items():
        for i, key in enumerate(d["keys"].tolist()):
            seq = d["vals"][d["start"][i]:d["start"][i] + d["n"][i]]
            for j, part in enumerate(np.array_split(seq, cuts)):
                if not len(part):
                    continue
                if kind == sgen.TIMER:
                    p = part.astype(np.float64)
                    v = np.r_[np.quantile(p, QS, method="hazen"), p.min(),
                              p.max(), len(p)]
                elif kind == sgen.COUNTER:
                    v = float(part.sum())
                elif kind == sgen.GAUGE:
                    v = float(part[-1])
                else:
                    v = float(len(part))
                k, vals = flushes[j].get(kind, ([], []))
                flushes[j][kind] = (k + [key], vals + [v])
    return [{kind: (np.array(k), np.array(v)) for kind, (k, v) in f.items()}
            for f in flushes]


@pytest.fixture
def local_case():
    seed = 2 ** 31 + 5
    pools = sgen.pool_lines(TRAFFIC, seed, 4000)
    sent = lref.Sent(TRAFFIC, seed, pools, [3000, 900])
    return sent, hand_rows(sent), seed


def judge(sent, rows, seed):
    return lref.judge(sent, rows, QS, 100.0, 14, seed)


def test_the_judge_takes_rows_worked_by_hand(local_case):
    sent, rows, seed = local_case
    v = judge(sent, rows, seed)
    assert v["correct"], v
    assert v["failed"] == 0
    assert v["checks"]["pct_rank_err_over_bound"][0] < 1e-3


def test_samples_in_counts_every_timer_and_counter_line(local_case):
    from portbench.cells.local import samples_in
    sent, rows, _ = local_case
    every = TRAFFIC["mix"]["counter"]["sampled_every"]
    lines = sum(int(sent.kinds[k]["n"].sum())
                for k in (sgen.TIMER, sgen.COUNTER))
    assert lines > 0
    assert sum(samples_in(f, every) for f in rows) == lines


def test_a_sender_past_its_pool_cycles_it():
    seed = 7
    pools = sgen.pool_lines(TRAFFIC, seed, 600)
    sent = lref.Sent(TRAFFIC, seed, pools, [2 * pools[0] + 30, pools[1]])
    assert judge(sent, hand_rows(sent, 3), seed)["correct"]


@pytest.mark.parametrize("fault,check", [
    ("count", "histo_count_gap"), ("min", "histo_minmax_off"),
    ("p99", "pct_rank_err_over_bound"), ("counter", "counter_off"),
    ("gauge", "gauge_off"), ("set", "set_err_over_bound"),
    ("stray", "stray_rows"), ("lost_row", "histo_count_gap")])
def test_each_check_catches_its_fault(local_case, fault, check):
    sent, rows, seed = local_case
    f = rows[0]
    k, v = f[sgen.TIMER]
    v = v.copy()
    if fault == "count":
        v[0, 5] += 1
    elif fault == "min":
        v[0, 3] = np.nextafter(np.float32(v[0, 3]), np.float32(0))
    elif fault == "p99":
        v[np.argmax(v[:, 5]), 2] *= 2
    elif fault == "lost_row":
        k, v = k[1:], v[1:]
    f[sgen.TIMER] = (k, v)
    if fault == "counter":
        ck, cv = f[sgen.COUNTER]
        f[sgen.COUNTER] = (ck, cv + 1)
    if fault == "gauge":
        gk, gv = rows[-1][sgen.GAUGE]
        rows[-1][sgen.GAUGE] = (gk, gv - 1)
    if fault == "set":
        sk, sv = f[sgen.SET]
        f[sgen.SET] = (sk, sv * 2 + 50)
    if fault == "stray":
        ck, cv = f[sgen.COUNTER]
        f[sgen.COUNTER] = (np.r_[ck, 10 ** 6], np.r_[cv, 1.0])
    out = judge(sent, rows, seed)
    assert not out["correct"]
    value, limit = out["checks"][check]
    assert value > limit, out["checks"]
