"""DogStatsD over UDP: the key plan, each sender's lines, and the sender.

A traffic file of this generator gives `mix` (per metric type: keys,
share of the lines, Zipf exponent), the number of sender processes and
an open loop: `rate_lines_per_s`, all senders together, reached by a
linear ramp over the first `ramp_s` seconds. Before the loop each
sender sends its prelude, one line of every key it owns, when told. A sender held up more than
MAX_CATCH_UP_S goes on at the rate from where it is. Every key belongs
to one sender (key % senders), and each sender sends from one socket,
so the port receives a key's samples in the order they were sent.

Everything here is a pure function of (traffic, seed) but `main`, the
sender process. The reference rebuilds the same arrays to re-aggregate
what was sent.
"""

from __future__ import annotations

import json
import math
import select
import socket
import sys
import time

import numpy as np

KINDS = ("timer", "counter", "gauge", "set")
TIMER, COUNTER, GAUGE, SET = range(4)
KEY_BITS = 24          # a line's key code is kind << KEY_BITS | key
TABLE = 1 << 16        # distinct timer values, lognormal(3, 1) ms
COUNTER_MID = TABLE    # table index of the counter increment "1"
MAX_CATCH_UP_S = 0.05  # a sender held up longer moves its schedule on
PREFIX = {TIMER: "pb.lat.", COUNTER: "pb.hits.", GAUGE: "pb.temp.",
          SET: "pb.users."}


def counter_sampled(key: int, every: int) -> bool:
    return every > 0 and key % every == 0


def key_text(kind: int, key: int, sampled_every: int) -> tuple:
    """(prefix, suffix) bytes of a line of this key; the value goes
    between them."""
    name = f"{PREFIX[kind]}{key}".encode()
    if kind == TIMER:
        return name + b":", b"|ms|#shard:%d,env:bench" % (key % 8)
    if kind == COUNTER:
        rate = b"|@0.5" if counter_sampled(key, sampled_every) else b""
        return name + b":", b"|c" + rate
    if kind == GAUGE:
        return name + b":", b"|g"
    return name + b":u", b"|s"


def expected_tags(kind: int, key: int) -> list:
    """The tags the port flushes for a key of this plan."""
    return ["env:bench", f"shard:{key % 8}"] if kind == TIMER else []


def value_table(seed: int) -> tuple:
    """The timer values as text and as the f32 the port keeps: TABLE
    lognormal(3, 1) draws at four decimals, then the counter's "1"."""
    rng = np.random.default_rng([seed, 1])
    text = [b"%.4f" % v for v in rng.lognormal(3.0, 1.0, TABLE)]
    text.append(b"1")
    vals = np.array([float(t) for t in text], np.float64).astype(np.float32)
    return text, vals


def key_probs(traffic: dict, seed: int) -> dict:
    """kind -> the probability of each of its keys in a line: the
    type's share of the lines times a Zipf law over its keys, whose
    ranks the seed permutes."""
    mix = traffic["mix"]
    total = sum(mix[k]["share"] for k in KINDS if k in mix)
    out = {}
    for kind, name in enumerate(KINDS):
        if name not in mix:
            continue
        m = mix[name]
        n = int(m["keys"])
        ranks = np.random.default_rng([seed, 2, kind]).permutation(n)
        p = 1.0 / np.power(ranks + 1.0, float(m["zipf"]))
        out[kind] = p / p.sum() * (m["share"] / total)
    return out


def sender_shares(traffic: dict, seed: int) -> np.ndarray:
    """Each sender's share of all lines: the mass of the keys it owns."""
    n = int(traffic["senders"])
    shares = np.zeros(n)
    for p in key_probs(traffic, seed).values():
        owner = np.arange(len(p)) % n
        shares += np.bincount(owner, weights=p, minlength=n)
    return shares


def sender_keys(traffic: dict, seed: int, s: int) -> tuple:
    """The key codes sender `s` owns, by kind and key, and the
    probability of each in a line of all senders."""
    n = int(traffic["senders"])
    codes, probs = [], []
    for kind, p in key_probs(traffic, seed).items():
        keys = np.arange(s, len(p), n)
        codes.append((kind << KEY_BITS) | keys)
        probs.append(p[keys])
    return np.concatenate(codes).astype(np.int64), np.concatenate(probs)


def prelude_datagrams(traffic: dict, s: int) -> int:
    """Datagrams of sender `s`'s prelude: one line of each key it owns,
    rounded up to whole datagrams."""
    n = int(traffic["senders"])
    keys = sum(len(range(s, int(m["keys"]), n))
               for m in traffic["mix"].values())
    return -(-keys // int(traffic["lines_per_datagram"]))


def pool_lines(traffic: dict, seed: int, total: int) -> list:
    """Lines in each sender's pool: its prelude, then its share of
    `total` lines, rounded up to whole datagrams."""
    L = int(traffic["lines_per_datagram"])
    return [prelude_datagrams(traffic, i) * L
            + int(-(-round(total * s) // L) * L)
            for i, s in enumerate(sender_shares(traffic, seed))]


def sender_arrays(traffic: dict, seed: int, s: int, n_lines: int) -> tuple:
    """The pool of sender `s`: (codes int64, mids int64), one entry a
    line, in the order sent (cycled when the run outlasts it); the first
    m lines of a pool of n are the pool of m. It opens with the prelude,
    one line of each key the sender owns in key order; the other lines
    draw their keys from the seed. A mid is the timer value's table
    index, COUNTER_MID, or for gauges and sets ~occurrence: the gauge's
    value and the set member's number count the key's lines in the pool
    from 1, so each differs from the last."""
    codes, probs = sender_keys(traffic, seed, s)
    lead = codes[:n_lines]
    pick = np.random.default_rng([seed, 3, s]).choice(
        len(codes), size=n_lines - len(lead), p=probs / probs.sum())
    line = np.r_[lead, codes[pick]]
    kind = line >> KEY_BITS
    mids = np.full(n_lines, COUNTER_MID, np.int64)
    t = kind == TIMER
    mids[t] = np.random.default_rng([seed, 4, s]).integers(
        0, TABLE, n_lines)[t]
    occ = occurrences(line)
    gs = (kind == GAUGE) | (kind == SET)
    mids[gs] = ~occ[gs]
    return line, mids


def occurrences(codes: np.ndarray) -> np.ndarray:
    """1 for a code's first line, 2 for its second, ..."""
    order = np.argsort(codes, kind="stable")
    sc = codes[order]
    start = np.r_[0, np.flatnonzero(np.diff(sc)) + 1]
    run = np.diff(np.r_[start, len(sc)])
    occ = np.empty(len(codes), np.int64)
    occ[order] = np.arange(len(sc)) - np.repeat(start, run) + 1
    return occ


def max_line_bytes(traffic: dict, table_text: list) -> int:
    mix = traffic["mix"]
    every = int(mix.get("counter", {}).get("sampled_every", 0))
    longest = 0
    for kind, name in enumerate(KINDS):
        if name not in mix:
            continue
        k = int(mix[name]["keys"]) - 1
        pre, suf = key_text(kind, k, every)
        if kind == TIMER:
            mid = max(map(len, table_text[:TABLE]))
        elif kind == COUNTER:
            mid = 1
        else:
            mid = len(str(traffic.get("max_occurrence", 10 ** 8)))
        longest = max(longest, len(pre) + mid + len(suf))
    return longest


def check_datagram_size(traffic: dict, table_text: list) -> None:
    L = int(traffic["lines_per_datagram"])
    size = L * (max_line_bytes(traffic, table_text) + 1) - 1
    if size > int(traffic["max_datagram_bytes"]):
        raise ValueError(f"{L} lines a datagram may take {size} bytes, over "
                         f"max_datagram_bytes {traffic['max_datagram_bytes']}")


class Lines:
    """Formats sender `s`'s datagrams from its pool: L lines each, the
    pool cycled."""

    def __init__(self, traffic: dict, seed: int, s: int, n_lines: int):
        self.L = int(traffic["lines_per_datagram"])
        codes, mids = sender_arrays(traffic, seed, s, n_lines)
        text, _ = value_table(seed)
        check_datagram_size(traffic, text)
        every = int(traffic["mix"].get("counter", {}).get("sampled_every",
                                                          0))
        uniq, inv = np.unique(codes, return_inverse=True)
        pres, sufs = zip(*(key_text(int(c) >> KEY_BITS,
                                    int(c) & ((1 << KEY_BITS) - 1), every)
                           for c in uniq))
        self.pre, self.suf, self.text = list(pres), list(sufs), text
        self.kidx = inv.reshape(-1).astype(np.int32)
        self.mids = mids
        self.P = n_lines

    def datagram(self, i: int) -> bytes:
        """The datagram holding lines i .. i + L - 1 of the cycled pool."""
        j = i % self.P
        ks = self.kidx[j:j + self.L].tolist()
        ms = self.mids[j:j + self.L].tolist()
        if len(ks) < self.L:
            r = self.L - len(ks)
            ks += self.kidx[:r].tolist()
            ms += self.mids[:r].tolist()
        pre, suf, text = self.pre, self.suf, self.text
        return b"\n".join([pre[k] + (text[m] if m >= 0 else b"%d" % ~m)
                           + suf[k] for k, m in zip(ks, ms)])


def _stop_asked() -> bool:
    """A line or the end of stdin: either stops the sender."""
    r, _, _ = select.select([0], [], [], 0)
    return bool(r)


def lines_due(t: float, rate: float, ramp_s: float) -> float:
    """Lines a sender owes `t` seconds after its start: a linear ramp to
    `rate` over `ramp_s` seconds, then `rate`."""
    if t <= 0:
        return 0.0
    if t < ramp_s:
        return rate * t * t / (2 * ramp_s)
    return rate * (t - ramp_s / 2)


def time_due(n: float, rate: float, ramp_s: float) -> float:
    """The inverse of lines_due: seconds after the start at which `n`
    lines are owed."""
    if ramp_s > 0 and n < rate * ramp_s / 2:
        return math.sqrt(2 * ramp_s * n / rate)
    return n / rate + ramp_s / 2


def main() -> None:
    """One sender process. argv[1] is its JSON spec; it prints
    {"ready": ...} once its pool is built. It then reads {"port"} from
    stdin, sends its prelude and prints {"primed": lines}; then reads
    {"t0", "rate"}, sends at the rate from t0 on until "stop" comes on
    stdin, and prints its report."""
    spec = json.loads(sys.argv[1])
    traffic, s = spec["traffic"], int(spec["sender"])
    lines = Lines(traffic, int(spec["seed"]), s, int(spec["pool_lines"]))
    print(json.dumps({"ready": True, "pool": lines.P}), flush=True)
    line = sys.stdin.readline()
    if not line:                 # the harness went away before the load
        return
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.connect(("127.0.0.1", int(json.loads(line)["port"])))
    L = lines.L
    sent = 0                     # lines sent
    for _ in range(prelude_datagrams(traffic, s)):
        sock.send(lines.datagram(sent))
        sent += L
        time.sleep(0.0005)
    print(json.dumps({"primed": sent}), flush=True)
    go = json.loads(sys.stdin.readline())
    rate = float(go["rate"])
    ramp = float(traffic.get("ramp_s", 0.0))
    first = sent                 # lines sent before the loop
    timeline = []
    max_lag = 0.0
    t0 = float(go["t0"])
    while time.monotonic() < t0:
        time.sleep(0.001)
    next_mark = t0
    held = 0.0                   # seconds the schedule was moved on
    while True:
        now = time.monotonic()
        if now >= next_mark:
            timeline.append((now, sent))
            next_mark = now + 0.005
            if _stop_asked():
                break
        t_due = t0 + time_due(sent - first + L, rate, ramp)
        if now >= t_due:
            lag = now - t_due
            max_lag = max(max_lag, lag)
            if lag > MAX_CATCH_UP_S:
                # this process was held up, as a loaded host holds every
                # process on it: go on at the rate from here rather than
                # send the backlog in one burst, which no client held up
                # with the port would send
                t0 += lag
                held += lag
                continue
            sock.send(lines.datagram(sent))
            sent += L
        else:
            time.sleep(min(0.001, t_due - now))
    timeline.append((time.monotonic(), sent))
    sock.close()
    print(json.dumps({"lines": sent, "timeline": timeline,
                      "max_lag_s": max_lag, "held_s": held}), flush=True)


if __name__ == "__main__":
    main()
