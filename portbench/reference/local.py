"""The reference of a DogStatsD local: what each key was sent, and the
judge of the flushed rows.

Every key comes from one sender's socket, so the port lands its samples
in the order they were sent, and each flush holds one contiguous run of
them. A histogram's `count` rows therefore say which run each flush
holds; the run is known, and so are its exact min, max and percentiles.
Counters carry their count in their sum (every increment is 1, weighed
by its sample rate). A gauge's value is its line's number among the
key's lines, so it says which line was the last to land. A set's
members are numbered likewise; the estimates of a key summed over the
flushes are held to the number of members it was sent.

The contract is the one the port's configuration states: counts, min,
max, counters and gauges exact; each percentile, in rank among the
run's samples, within half a k1 cluster of its quantile plus one sample
(t-digest at compression 100); each set estimate within 3 standard
errors plus one member.
"""

from __future__ import annotations

import numpy as np

from ..gen import statsd as gen

HISTO, COUNTER, GAUGE, SET = gen.TIMER, gen.COUNTER, gen.GAUGE, gen.SET
PCT_LIMIT = 1.0
SET_LIMIT = 1.0


class Sent:
    """Per kind, what every key was sent, in order: `keys` (sorted),
    `start` and `n` into `vals`, and `pool_n` (the key's lines in its
    sender's pool, so the distinct set members are min(n, pool_n))."""

    def __init__(self, traffic: dict, seed: int, pools: list, sent: list,
                 precision=np.float32):
        _, table = gen.value_table(seed)
        every = int(traffic["mix"].get("counter", {}).get("sampled_every",
                                                          0))
        keys = {k: [] for k in range(4)}
        vals = {k: [] for k in range(4)}
        pool_n = {k: [] for k in range(4)}
        for s, (P, m) in enumerate(zip(pools, sent)):
            codes, mids = gen.sender_arrays(traffic, seed, s, P if m > P
                                            else m)
            pos = np.arange(m) % P
            c, md = codes[pos], mids[pos]
            kind = c >> gen.KEY_BITS
            key = c & ((1 << gen.KEY_BITS) - 1)
            for k in range(4):
                sel = kind == k
                keys[k].append(key[sel])
                if k == HISTO:
                    v = table[md[sel]].astype(precision)
                elif k == COUNTER:
                    v = weights(key[sel], every)
                else:
                    v = ~md[sel]
                vals[k].append(v)
                pk = codes[(codes >> gen.KEY_BITS) == k] \
                    & ((1 << gen.KEY_BITS) - 1)
                pool_n[k].append(pk)
        self.kinds = {}
        for k in range(4):
            ka = np.concatenate(keys[k]) if keys[k] else np.zeros(0, np.int64)
            va = np.concatenate(vals[k]) if vals[k] else np.zeros(0)
            order = np.argsort(ka, kind="stable")
            uk, start, n = np.unique(ka[order], return_index=True,
                                     return_counts=True)
            pk, pc = np.unique(np.concatenate(pool_n[k]), return_counts=True)
            self.kinds[k] = {"keys": uk, "start": start, "n": n,
                             "vals": va[order],
                             "pool_n": pc[np.searchsorted(pk, uk)]}

    def lookup(self, kind: int, keys: np.ndarray) -> tuple:
        """(index into this kind's keys, known mask) of row keys."""
        uk = self.kinds[kind]["keys"]
        i = np.searchsorted(uk, keys)
        i = np.minimum(i, max(len(uk) - 1, 0))
        known = (uk[i] == keys) if len(uk) else np.zeros(len(keys), bool)
        return i, known


def weights(keys: np.ndarray, every: int) -> np.ndarray:
    """A counter line's weight: 2 for a key sampled at @0.5, else 1."""
    if not every:
        return np.ones(len(keys))
    return np.where(keys % every == 0, 2.0, 1.0)


def _stack(flushes: list, kind: int, width: int = 0) -> tuple:
    """(flush index, key, row values) of every row of `kind`."""
    js, ks, vs = [], [], []
    for j, f in enumerate(flushes):
        if kind in f:
            k, v = f[kind]
            js.append(np.full(len(k), j))
            ks.append(k)
            vs.append(v)
    if not ks:
        return (np.zeros(0, int), np.zeros(0, np.int64),
                np.zeros((0, width) if width else 0))
    return np.concatenate(js), np.concatenate(ks), np.concatenate(vs)


def hazen_ranks(xs: np.ndarray, got) -> tuple:
    """The ranks each value of `got` takes among each sorted row of
    `xs` ([m, n], or one row [n]) on the hazen plotting positions: (i +
    1/2) / n for the i-th smallest sample, linear between them, 0 and 1
    past min and max. A value within a few f32 roundings (rtol 1e-6) of
    samples counts as those samples. Returns (lowest, highest), each
    [m, len(got)] (or [len(got)] for one row); outside the samples the
    pair is (inf, -inf)."""
    one = xs.ndim == 1
    x = np.atleast_2d(xs).astype(np.float64)
    m, n = x.shape
    g = np.asarray(got, np.float32).astype(np.float64)
    tol = 1e-6 * np.abs(g)
    lt = (x[:, :, None] < (g - tol)[None, None, :]).sum(1)
    le = (x[:, :, None] <= (g + tol)[None, None, :]).sum(1)
    tie = le > lt
    r_lo = np.where(lt == 0, 0.0, (lt + 0.5) / n)
    r_hi = np.where(le == n, 1.0, (le - 0.5) / n)
    k = np.clip(lt, 1, n - 1)
    a = np.take_along_axis(x, k - 1, 1)
    b = np.take_along_axis(x, k, 1)
    frac = np.where(b > a, (g[None, :] - a) / np.where(b > a, b - a, 1.0),
                    0.0)
    between = (k - 0.5 + frac) / n
    inside = (lt > 0) & (lt < n)
    r_lo = np.where(tie, r_lo, np.where(inside, between, np.inf))
    r_hi = np.where(tie, r_hi, np.where(inside, between, -np.inf))
    return (r_lo[0], r_hi[0]) if one else (r_lo, r_hi)


def rank_error(run: np.ndarray, got: np.ndarray, qs: tuple) -> np.ndarray:
    """How far, in rank, each percentile lies from its quantile among
    the run's samples (hazen_ranks): 0 for an exact hazen quantile, at
    most 1."""
    lo, hi = hazen_ranks(np.sort(np.asarray(run, np.float32)), got)
    q = np.asarray(qs)
    return np.minimum(np.maximum(np.maximum(lo - q, q - hi), 0.0), 1.0)


def pct_bound(qs: tuple, compression: float, n: int) -> np.ndarray:
    """Half the rank a k1 cluster spans at q, (pi / compression) *
    sqrt(q (1 - q)), plus one sample: the t-digest's own bound on a
    percentile's error in rank."""
    q = np.asarray(qs)
    return np.pi / compression * np.sqrt(q * (1 - q)) + 1.0 / n


def judge(sent: Sent, flushes: list, qs: tuple, compression: float,
          hll_precision: int, seed: int, sample: int = 200) -> dict:
    """Hold every flush's rows to what was sent. `flushes[j][kind]` is
    (keys, values): a timer's values are the rows [p for qs] + [min,
    max, count]; a scalar's its value. Returns the numbers compared,
    each beside its limit, the samples the rows show missing, and notes
    on the first faults."""
    out = {"checks": {}, "failed": 0, "notes": []}
    note = out["notes"]
    rng = np.random.default_rng([seed, 99])
    nq = len(qs)

    # histograms: counts locate each flush's run
    h = sent.kinds[HISTO]
    j, k, v = _stack(flushes, HISTO, nq + 3)
    idx, known = sent.lookup(HISTO, k)
    stray = int((~known).sum())
    got = np.bincount(idx[known], weights=v[known, nq + 2],
                      minlength=len(h["keys"])) if len(h["keys"]) else \
        np.zeros(0)
    gap = np.abs(got - h["n"])
    out["failed"] += int(np.maximum(h["n"] - got, 0).sum())
    out["checks"]["histo_count_gap"] = [float(gap.sum()), 0]
    if gap.sum():
        note.append(f"histogram counts off on {int((gap > 0).sum())} keys")
    ok_key = gap == 0
    sel = known & ok_key[idx]
    j, idx, v = j[sel], idx[sel], v[sel]
    order = np.lexsort((j, idx))
    j, idx, v = j[order], idx[order], v[order]
    cnt = v[:, nq + 2].astype(np.int64)
    first = np.r_[True, idx[1:] != idx[:-1]]
    csum = np.cumsum(cnt)
    base = np.maximum.accumulate(np.where(first, csum - cnt, 0))
    seg0 = h["start"][idx] + (csum - cnt - base)
    seg1 = seg0 + cnt
    vals = np.r_[h["vals"], h["vals"][:1]]
    bounds = np.stack([seg0, seg1], 1).reshape(-1)
    if len(seg0):
        mins = np.minimum.reduceat(vals, bounds)[::2]
        maxs = np.maximum.reduceat(vals, bounds)[::2]
        off = (mins != v[:, nq].astype(np.float32)) \
            | (maxs != v[:, nq + 1].astype(np.float32))
    else:
        off = np.zeros(0, bool)
    out["checks"]["histo_minmax_off"] = [int(off.sum()), 0]
    if off.any():
        i = int(np.flatnonzero(off)[0])
        note.append(f"flush {j[i]} timer {h['keys'][idx[i]]}: min/max "
                    f"{v[i, nq]}/{v[i, nq + 1]}, sent {mins[i]}/{maxs[i]}")
    # percentiles: the longest runs of each flush and a seeded sample
    picks = set()
    for jj in np.unique(j):
        rows = np.flatnonzero(j == jj)
        picks.update(rows[np.argsort(-cnt[rows])[:5]].tolist())
        picks.update(rng.choice(rows, min(sample, len(rows)),
                                replace=False).tolist())
    worst, where = 0.0, None
    for i in sorted(picks):
        err = (rank_error(h["vals"][seg0[i]:seg1[i]], v[i, :nq], qs)
               / pct_bound(qs, compression, int(cnt[i]))).max()
        if err > worst:
            worst, where = float(err), i
    out["checks"]["pct_rank_err_over_bound"] = [worst, PCT_LIMIT]
    out["pct_checked"] = len(picks)
    if worst > PCT_LIMIT:
        run = np.sort(h["vals"][seg0[where]:seg1[where]])
        note.append(f"flush {j[where]} timer {h['keys'][idx[where]]}: "
                    f"percentiles {v[where, :nq].tolist()} off in rank by "
                    f"{worst} of the t-digest's bound; its {len(run)} "
                    f"samples {run[:5].tolist()} .. {run[-5:].tolist()}, "
                    "hazen " + str(np.quantile(run.astype(np.float64), qs,
                                                method="hazen").tolist()))

    # counters: a sum counts the increments
    c = sent.kinds[COUNTER]
    j, k, v = _stack(flushes, COUNTER)
    idx, known = sent.lookup(COUNTER, k)
    w = c["vals"][c["start"][idx]] if len(c["keys"]) else np.zeros(len(k))
    n = np.rint(v / w)
    stray += int((~known).sum())
    bad = known & ((n < 1) | (n * w != v))
    got = np.bincount(idx[known], weights=n[known],
                      minlength=len(c["keys"])) if len(c["keys"]) else \
        np.zeros(0)
    out["failed"] += int(np.maximum(c["n"] - got, 0).sum())
    off = int(bad.sum()) + int((got != c["n"]).sum())
    out["checks"]["counter_off"] = [off, 0]
    if off:
        note.append(f"counters off: {int(bad.sum())} rows, "
                    f"{int((got != c['n']).sum())} key totals")

    # gauges: the line each flush's value names rises, and ends at the last
    g = sent.kinds[GAUGE]
    j, k, v = _stack(flushes, GAUGE)
    idx, known = sent.lookup(GAUGE, k)
    stray += int((~known).sum())
    off = 0
    order = np.lexsort((j, idx))
    j, idx, v, known = j[order], idx[order], v[order], known[order]
    last = np.zeros(len(g["keys"]), np.int64)   # lines proved landed
    for r in np.flatnonzero(known):
        K = idx[r]
        seq = g["vals"][g["start"][K]:g["start"][K] + g["n"][K]]
        hit = np.flatnonzero(seq[last[K]:] == v[r])
        if hit.size == 0:
            off += 1
            continue
        last[K] += int(hit[0]) + 1
    tail = g["vals"][g["start"] + g["n"] - 1] if len(g["keys"]) else []
    final = {}
    for r in np.flatnonzero(known):
        final[idx[r]] = v[r]
    unfinished = sum(1 for K in range(len(g["keys"]))
                     if final.get(K) != tail[K])
    out["failed"] += int((g["n"] - last)[last < g["n"]].sum()) \
        if unfinished else 0
    out["checks"]["gauge_off"] = [off + unfinished, 0]
    if off or unfinished:
        note.append(f"gauges off: {off} rows, {unfinished} keys whose last "
                    "line is not the last flushed")

    # sets: the estimates summed over flushes against the members sent
    st = sent.kinds[SET]
    j, k, v = _stack(flushes, SET)
    idx, known = sent.lookup(SET, k)
    sigma = 1.04 / np.sqrt(2.0 ** hll_precision)
    total = np.bincount(idx[known], weights=v[known],
                        minlength=len(st["keys"])) if len(st["keys"]) else \
        np.zeros(0)
    flushes_of = np.bincount(idx[known], minlength=len(st["keys"]))
    N = st["n"].astype(np.float64)
    D = np.minimum(st["n"], st["pool_n"]).astype(np.float64)
    tol = 3 * sigma * N + flushes_of
    err = np.maximum(np.maximum(D - total, total - N), 0) / tol \
        if len(N) else np.zeros(0)
    worst = float(err.max()) if len(err) else 0.0
    stray += int((~known).sum())
    out["checks"]["set_err_over_bound"] = [worst, SET_LIMIT]
    if worst > SET_LIMIT:
        note.append(f"sets off: worst estimate sum {worst} of its bound")
    out["checks"]["stray_rows"] = [stray, 0]
    if stray:
        note.append(f"{stray} rows of keys never sent")
    out["correct"] = all(val <= lim for val, lim in out["checks"].values())
    return out
