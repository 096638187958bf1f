"""The durability subsystem on the port (veneur_tpu_torch/durability/):
tests/test_durability.py with the port's modules in place of the
reference's, then the two packages held against each other.

The reference's layers, run against the port:

  * golden bytes — the frame layout (length | crc32c | type | payload),
    the file magics, and the typed record encodings are pinned to
    hand-constructed constants, so any byte-level drift fails loudly
    instead of silently orphaning existing journals;
  * randomized roundtrip — export payloads (centroids, HLL registers,
    exact counters, gauges) survive encode/decode bit-exactly;
  * torn-write / bit-flip fuzz — recovery over corrupted journals NEVER
    raises and NEVER invents records: what comes back is always a
    bit-exact prefix of what was appended;
  * forwarder recovery and the engine checkpoint (engines on the CPU,
    `device="cpu"`).

Then, across the packages (`TestGoldenBytesAcrossPackages`,
`TestCrossRestore`): CRC32C, frames, journal and snapshot files and
every record kind are byte for byte the reference's on the same inputs
made from a seed; a checkpoint taken by either package's engine restores
into the other's for both engine pairs (tdigest+hll, req+ull), and the
two flushes agree under ROADMAP's comparison contract (count, min, max,
counters, gauges and register bytes exact; quantiles within 1% of the
key's spread for t-digest, rtol 1e-4 for REQ; HLL estimates within
rtol 1e-5, ULL exact); a fingerprint mismatch is refused in both
directions; and a restored port engine flushes bit for bit like its
uncrashed twin.
"""

import os
import random
import struct

import numpy as np
import pytest

from veneur_tpu_torch.durability import (ForwardJournal, Journal,
                                   WatermarkJournal, crc32c)
from veneur_tpu_torch.durability import records as drec
from veneur_tpu_torch.durability.journal import (HEADER_BYTES, MAGIC,
                                           SNAP_MAGIC, decode_frames,
                                           encode_frame)
from veneur_tpu_torch.ingest.parser import MetricKey
from veneur_tpu_torch.models.pipeline import ForwardExport
from veneur_tpu_torch.resilience import (ForwardEnvelope, PartialDeliveryError,
                                   ResilienceRegistry, ResilientForwarder)
from veneur_tpu_torch.utils.faults import FakeClock, ScriptedCallable


def mk_export(seed: int = 0, n_keys: int = 3) -> ForwardExport:
    rng = np.random.default_rng(seed)
    exp = ForwardExport()
    for k in range(n_keys):
        n = int(rng.integers(1, 40))
        means = np.sort(rng.normal(100, 20, n).astype(np.float32))
        weights = rng.uniform(0.5, 4.0, n).astype(np.float32)
        exp.histograms.append(
            (MetricKey(f"h{k}", "timer", "a:b"), means, weights,
             float(means.min()), float(means.max()),
             float((means * weights).sum()), float(weights.sum()),
             float(rng.uniform(0, 2))))
    regs = rng.integers(0, 40, 1 << 4).astype(np.uint8)
    exp.sets.append((MetricKey(f"s{seed}", "set", ""), regs))
    exp.counters.append((MetricKey("c", "counter", "x:y"),
                         float(rng.uniform(0, 100))))
    exp.gauges.append((MetricKey("g", "gauge", ""),
                       float(rng.normal())))
    return exp


def assert_export_equal(a: ForwardExport, b: ForwardExport):
    assert len(a.histograms) == len(b.histograms)
    for ea, eb in zip(a.histograms, b.histograms):
        assert ea[0] == eb[0]
        np.testing.assert_array_equal(ea[1], eb[1])
        np.testing.assert_array_equal(ea[2], eb[2])
        assert tuple(float(x) for x in ea[3:]) == \
            tuple(float(x) for x in eb[3:])
    assert [k for k, _ in a.sets] == [k for k, _ in b.sets]
    for (_, ra), (_, rb) in zip(a.sets, b.sets):
        np.testing.assert_array_equal(np.asarray(ra), np.asarray(rb))
    assert [(k, float(v)) for k, v in a.counters] == \
        [(k, float(v)) for k, v in b.counters]
    assert [(k, float(v)) for k, v in a.gauges] == \
        [(k, float(v)) for k, v in b.gauges]


# ----------------------------------------------------------- golden bytes

class TestGoldenBytes:
    def test_crc32c_check_value(self):
        # the CRC-32C check value from RFC 3720 / every published
        # Castagnoli test vector
        assert crc32c(b"123456789") == 0xE3069283
        assert crc32c(b"") == 0

    def test_frame_golden_bytes(self):
        # u32 length (type byte + payload) | u32 crc32c | type | payload
        frame = encode_frame(1, b"hi")
        golden = (struct.pack("<I", 3)
                  + struct.pack("<I", crc32c(b"\x01hi"))
                  + b"\x01hi")
        assert frame == golden
        assert frame == bytes.fromhex("03000000149fd9c1016869")
        recs, end, torn = decode_frames(frame)
        assert recs == [(1, b"hi")] and end == len(frame) and not torn

    def test_empty_payload_frame_golden_bytes(self):
        assert encode_frame(9, b"") == bytes.fromhex("010000009d88cf2a09")

    def test_file_magics_pinned(self):
        assert MAGIC == b"VTPUJRN1"
        assert SNAP_MAGIC == b"VTPUSNP1"

    def test_journal_file_golden_bytes(self, tmp_path):
        j = Journal(str(tmp_path), "g", fsync="never")
        j.load()
        j.append(1, b"hi")
        j.append(9, b"")
        j.close()
        with open(j.journal_path, "rb") as f:
            # magic | u64 generation 0 | frames
            assert f.read() == MAGIC + bytes(8) + bytes.fromhex(
                "03000000149fd9c1016869010000009d88cf2a09")

    def test_meta_record_golden_bytes(self):
        # u32 len | utf8 sender_id | u64 next_seq
        assert drec.encode_meta("s1", 7) == bytes.fromhex(
            "0200000073310700000000000000")
        assert drec.decode_meta(drec.encode_meta("s1", 7)) == ("s1", 7)

    def test_watermarks_record_golden_bytes(self):
        # u32 count | (u32 len | utf8 sender | u64 seq)*
        assert drec.encode_watermarks({"a": 5}) == bytes.fromhex(
            "0100000001000000610500000000000000")
        assert drec.decode_watermarks(
            drec.encode_watermarks({"a": 5})) == {"a": 5}

    def test_export_payload_reuses_the_wire_codec(self):
        # the sketch body of an export payload IS a serialized
        # forwardrpc.MetricList — the same bytes the forwarder puts on
        # the wire — plus exact f64 counters appended
        from veneur_tpu_torch.cluster.protos import forward_pb2
        exp = ForwardExport()
        exp.counters.append((MetricKey("c", "counter", ""), 7.25))
        data = drec.encode_export(exp)
        (blob_len,) = struct.unpack_from("<I", data, 0)
        blob = data[4:4 + blob_len]
        ml = forward_pb2.MetricList.FromString(blob)
        assert ml.metrics[0].counter.value == 7     # wire rounds...
        (exact,) = struct.unpack_from("<d", data, 4 + blob_len)
        assert exact == 7.25                        # ...journal doesn't
        back, off = drec.decode_export(data)
        assert off == len(data)
        assert back.counters[0][1] == 7.25


# ----------------------------------------------------- randomized roundtrip

class TestRandomizedRoundtrip:
    def test_export_payload_roundtrip(self):
        for seed in range(25):
            exp = mk_export(seed, n_keys=4)
            back, off = drec.decode_export(drec.encode_export(exp))
            assert off == len(drec.encode_export(exp))
            assert_export_equal(exp, back)

    def test_begin_record_roundtrip(self):
        exp = mk_export(3)
        payload = drec.encode_begin(42, 2, 5, 1, exp)
        seq, off, cnt, age, back, kind = drec.decode_begin(payload)
        assert (seq, off, cnt, age, kind) == (42, 2, 5, 1, "full")
        assert_export_equal(exp, back)

    def test_begin_record_pins_delta_kind(self):
        """A parked DELTA interval recovers as a delta (the kind byte
        trails the export payload); a pre-delta record — no
        trailing byte — reads as full, which every pre-delta interval
        was."""
        exp = mk_export(4)
        payload = drec.encode_begin(7, 0, 0, 0, exp, "delta")
        *_head, back, kind = drec.decode_begin(payload)
        assert kind == "delta"
        assert_export_equal(exp, back)
        legacy = drec.encode_begin(7, 0, 0, 0, exp)[:-1]  # strip byte
        *_head, back2, kind2 = drec.decode_begin(legacy)
        assert kind2 == "full"
        assert_export_equal(exp, back2)

    def test_journal_append_reload_roundtrip(self, tmp_path):
        rng = random.Random(11)
        j = Journal(str(tmp_path), "rt", fsync="never")
        j.load()
        written = []
        for _ in range(200):
            rec = (rng.randrange(1, 10),
                   rng.randbytes(rng.randrange(0, 500)))
            written.append(rec)
            j.append(*rec)
        j.close()
        j2 = Journal(str(tmp_path), "rt", fsync="never")
        _snap, recs = j2.load()
        assert recs == written
        j2.close()

    def test_watermark_journal_merges_by_max(self, tmp_path):
        w = WatermarkJournal(str(tmp_path), fsync="never")
        assert w.load() == {}
        w.record({"a": 5, "b": 2})
        w.record({"a": 7})
        w.record({"a": 3})              # regressions never recorded
        w.close()
        w2 = WatermarkJournal(str(tmp_path), fsync="never")
        assert w2.load() == {"a": 7, "b": 2}
        w2.close()


# ------------------------------------------------- torn-write / flip fuzz

class TestTornWriteFuzz:
    def _written(self, tmp_path, n=40, seed=5):
        rng = random.Random(seed)
        j = Journal(str(tmp_path), "fz", fsync="never")
        j.load()
        written = []
        for _ in range(n):
            rec = (rng.randrange(1, 250),
                   rng.randbytes(rng.randrange(0, 120)))
            written.append(rec)
            j.append(*rec)
        j.close()
        return j.journal_path, written

    def test_truncation_never_raises_never_invents(self, tmp_path):
        path, written = self._written(tmp_path)
        blob = open(path, "rb").read()
        for cut in range(len(blob)):
            recs, _end, _torn = decode_frames(blob[:cut], HEADER_BYTES) \
                if cut >= HEADER_BYTES else ([], 0, True)
            # a truncated journal yields a bit-exact PREFIX, only
            assert recs == written[:len(recs)]

    def test_bit_flip_never_raises_never_invents(self, tmp_path):
        path, written = self._written(tmp_path)
        blob = bytearray(open(path, "rb").read())
        rng = random.Random(99)
        for _ in range(300):
            i = rng.randrange(HEADER_BYTES, len(blob))
            bit = 1 << rng.randrange(8)
            blob[i] ^= bit
            recs, _end, torn = decode_frames(bytes(blob), HEADER_BYTES)
            # the flip either hit the already-truncated tail (no-op) or
            # cut the scan earlier; either way: bit-exact prefix. The
            # one theoretically-surviving case is a 2^-32 CRC collision.
            assert recs == written[:len(recs)]
            if len(recs) < len(written):
                assert torn
            blob[i] ^= bit              # restore for the next trial

    def test_recovery_after_corruption_resumes_appending(self, tmp_path):
        path, written = self._written(tmp_path, n=10)
        with open(path, "r+b") as f:    # flip one byte mid-file
            f.seek(HEADER_BYTES + 30)
            b = f.read(1)
            f.seek(HEADER_BYTES + 30)
            f.write(bytes([b[0] ^ 0xFF]))
        reg = ResilienceRegistry()
        j = Journal(str(tmp_path), "fz", fsync="never", registry=reg)
        _snap, recs = j.load()
        assert recs == written[:len(recs)] and len(recs) < len(written)
        assert reg.peek("durability", "durability.truncated_frames") == 1
        j.append(77, b"fresh")
        j.close()
        j2 = Journal(str(tmp_path), "fz", fsync="never")
        _snap, recs2 = j2.load()
        assert recs2 == recs + [(77, b"fresh")]
        j2.close()

    def test_corrupt_snapshot_is_dropped_not_fatal(self, tmp_path):
        j = Journal(str(tmp_path), "sn", fsync="never")
        j.load()
        j.append(1, b"a")
        j.snapshot([(2, b"state")])
        j.append(3, b"post")
        j.close()
        # corrupt the snapshot body
        with open(j.snapshot_path, "r+b") as f:
            f.seek(HEADER_BYTES + 9)
            f.write(b"\xff")
        reg = ResilienceRegistry()
        j2 = Journal(str(tmp_path), "sn", fsync="never", registry=reg)
        snap, recs = j2.load()
        assert snap is None             # dropped whole, never raises
        assert recs == [(3, b"post")]   # journal survives independently
        assert reg.peek("durability", "durability.truncated_frames") == 1
        j2.close()


# -------------------------------------------------- snapshot + compaction

class TestSnapshotCompaction:
    def test_snapshot_then_truncate_roundtrip(self, tmp_path):
        j = Journal(str(tmp_path), "c", fsync="never")
        j.load()
        for i in range(20):
            j.append(1, bytes([i]))
        j.snapshot([(2, b"full-state")])
        assert j.size_bytes() == HEADER_BYTES   # compacted
        j.append(3, b"tail")
        j.close()
        j2 = Journal(str(tmp_path), "c", fsync="never")
        snap, recs = j2.load()
        assert snap == [(2, b"full-state")]
        assert recs == [(3, b"tail")]
        j2.close()

    def test_crash_between_rename_and_truncate_never_double_applies(
            self, tmp_path):
        """The compaction crash window: the new snapshot has landed
        (rename durable) but the journal was not yet truncated. The
        journal's records are ALREADY inside the snapshot — recovery
        must drop them by generation, not replay them on top."""
        j = Journal(str(tmp_path), "gw", fsync="never")
        j.load()
        for i in range(5):
            j.append(1, bytes([i]))
        pre_truncate = open(j.journal_path, "rb").read()
        j.snapshot([(2, b"folded-state")])
        j.close()
        # crash simulation: restore the PRE-truncate journal next to
        # the NEW snapshot
        with open(j.journal_path, "wb") as f:
            f.write(pre_truncate)
        reg = ResilienceRegistry()
        j2 = Journal(str(tmp_path), "gw", fsync="never", registry=reg)
        snap, recs = j2.load()
        assert snap == [(2, b"folded-state")]
        assert recs == []          # stale ops dropped, not re-applied
        assert reg.peek("durability",
                        "durability.stale_journal_dropped") == 1
        # and the restamped journal keeps working at the new generation
        j2.append(3, b"fresh")
        j2.close()
        j3 = Journal(str(tmp_path), "gw", fsync="never")
        snap3, recs3 = j3.load()
        assert snap3 == [(2, b"folded-state")]
        assert recs3 == [(3, b"fresh")]
        j3.close()

    def test_second_appender_rejected_until_lock_released(
            self, tmp_path):
        """Two live appenders on one journal corrupt each other; the
        advisory flock makes the second one fail LOUDLY. A (simulated)
        SIGKILL releases the lock like the kernel would."""
        from veneur_tpu_torch.utils.faults import kill_journal_lock
        j = Journal(str(tmp_path), "lk", fsync="never")
        j.load()
        j.append(1, b"a")
        with pytest.raises(RuntimeError, match="locked by a live"):
            Journal(str(tmp_path), "lk", fsync="never")
        kill_journal_lock(j)            # the process "dies"
        j2 = Journal(str(tmp_path), "lk", fsync="never")
        _snap, recs = j2.load()
        assert recs == [(1, b"a")]      # appended bytes survived
        j2.close()

    def test_leftover_tmp_file_is_ignored(self, tmp_path):
        j = Journal(str(tmp_path), "c", fsync="never")
        j.load()
        j.snapshot([(2, b"s1")])
        j.close()
        # simulate a crash mid-snapshot: a stale .tmp next to the real one
        with open(j.snapshot_path + ".tmp", "wb") as f:
            f.write(b"garbage half-written")
        j2 = Journal(str(tmp_path), "c", fsync="never")
        snap, _recs = j2.load()
        assert snap == [(2, b"s1")]
        j2.close()

    def test_forward_journal_compaction_preserves_ladder(self, tmp_path):
        clock = FakeClock()
        reg = ResilienceRegistry()
        inner = ScriptedCallable(["refused"], clock)
        fj = ForwardJournal(str(tmp_path), fsync="never",
                            snapshot_journal_bytes=4096)
        fwd = ResilientForwarder(inner, destination="d", sender_id="sid",
                                 seq_start=1, journal=fj, clock=clock,
                                 registry=reg)
        for seed in range(4):           # park 4 intervals
            with pytest.raises(ConnectionRefusedError):
                fwd(mk_export(seed))
        fwd.journal_tick()              # big enough -> compacts
        assert fj.size_bytes() == HEADER_BYTES
        entries = [(e.seq, e.age) for e in fwd._entries]
        fj.close()
        fj2 = ForwardJournal(str(tmp_path), fsync="never")
        fwd2 = ResilientForwarder(ScriptedCallable(["ok"], clock),
                                  destination="d", sender_id="x",
                                  seq_start=1, journal=fj2, clock=clock,
                                  registry=ResilienceRegistry())
        assert fwd2.sender_id == "sid"
        assert [(e.seq, e.age) for e in fwd2._entries] == entries
        for (ea, eb) in zip(fwd._entries, fwd2._entries):
            assert_export_equal(ea.export, eb.export)
        assert fwd2._next_seq == fwd._next_seq
        fj2.close()


# -------------------------------------------------- fsync policy plumbing

class TestFsyncPolicy:
    def test_policy_validated(self, tmp_path):
        with pytest.raises(ValueError):
            Journal(str(tmp_path), "x", fsync="sometimes")

    def test_fsync_counts_by_policy(self, tmp_path, monkeypatch):
        calls = []
        real = os.fsync
        monkeypatch.setattr(os, "fsync", lambda fd: calls.append(fd)
                            or real(fd))
        clock = FakeClock()
        for policy, appends, expect in (
                ("always", 3, 3), ("never", 3, 0)):
            j = Journal(str(tmp_path), f"p_{policy}", fsync=policy,
                        clock=clock)
            j.load()
            calls.clear()      # load() may fsync the fresh header
            for i in range(appends):
                j.append(1, b"x")
            assert len(calls) == expect, policy
            j.close()

    def test_interval_policy_batches_fsyncs(self, tmp_path, monkeypatch):
        calls = []
        real = os.fsync
        monkeypatch.setattr(os, "fsync", lambda fd: calls.append(fd)
                            or real(fd))
        clock = FakeClock()
        j = Journal(str(tmp_path), "iv", fsync="interval",
                    fsync_interval_s=1.0, clock=clock)
        j.load()
        calls.clear()          # load() fsyncs the fresh header
        for _ in range(10):
            j.append(1, b"x")
        assert calls == []              # within the interval: none
        clock.advance(1.5)
        j.append(1, b"x")
        assert len(calls) == 1          # interval elapsed -> one fsync
        j.sync()
        assert len(calls) == 2          # flush boundary forces one
        j.close()


# ------------------------------------------- forwarder recovery semantics

class TestForwarderRecovery:
    def _mk(self, tmp_path, schedule, clock=None, reg=None, **kw):
        clock = clock or FakeClock()
        reg = reg or ResilienceRegistry()
        inner = ScriptedCallable(schedule, clock)
        fj = ForwardJournal(str(tmp_path), fsync="never")
        fwd = ResilientForwarder(inner, destination="d", sender_id="sid",
                                 seq_start=1, journal=fj, clock=clock,
                                 registry=reg, **kw)
        return fwd, inner, fj, reg

    def test_clean_delivery_leaves_nothing_to_recover(self, tmp_path):
        fwd, _inner, fj, _ = self._mk(tmp_path, ["ok"])
        fwd(mk_export(0))
        fj.close()
        fwd2, _i2, fj2, reg2 = self._mk(tmp_path, ["ok"])
        assert fwd2._entries == [] and len(fwd2.spill) == 0
        assert reg2.peek("d", "durability.recovered_intervals") == 0
        assert fwd2._next_seq == 2      # seq space continues
        fj2.close()

    def test_crash_between_send_and_done_replays_and_dedupes(
            self, tmp_path):
        """The ambiguous crash window: delivery succeeded, the process
        died before the DONE record. Recovery MUST replay (at-least-
        once at this layer); the receiver's dedupe ledger is what makes
        it exactly-once — prove the replay carries the ORIGINAL
        envelope so the ledger can actually see it."""
        from veneur_tpu_torch.utils.faults import SimulatedKill
        fwd, inner, fj, _ = self._mk(tmp_path, ["kill_after_send"])
        with pytest.raises(SimulatedKill):
            fwd(mk_export(0))
        assert len(inner.delivered) == 1        # the body DID land
        fj.close()
        sent = []

        class Rec:
            def __call__(self, export, envelope=None):
                sent.append(envelope)
        clock = FakeClock()
        fj2 = ForwardJournal(str(tmp_path), fsync="never")
        reg2 = ResilienceRegistry()
        fwd2 = ResilientForwarder(Rec(), destination="d", sender_id="x",
                                  seq_start=1, journal=fj2, clock=clock,
                                  registry=reg2)
        assert reg2.peek("d", "durability.recovered_intervals") == 1
        fwd2(ForwardExport())
        assert [e.interval_seq for e in sent] == [1]
        assert sent[0].sender_id == "sid"       # original identity
        fj2.close()

    def test_partial_tail_recovers_chunk_progress(self, tmp_path):
        exp = mk_export(1)
        tail = ForwardExport()
        tail.gauges.extend(exp.gauges)

        class PartialInner:
            def __call__(self, export, envelope=None):
                raise PartialDeliveryError(tail, TimeoutError("t"),
                                           delivered_chunks=2,
                                           chunk_count=3)
        clock = FakeClock()
        fj = ForwardJournal(str(tmp_path), fsync="never")
        fwd = ResilientForwarder(PartialInner(), destination="d",
                                 sender_id="sid", seq_start=1,
                                 journal=fj, clock=clock,
                                 registry=ResilienceRegistry())
        with pytest.raises(PartialDeliveryError):
            fwd(exp)
        fj.close()
        fj2 = ForwardJournal(str(tmp_path), fsync="never")
        fwd2 = ResilientForwarder(ScriptedCallable(["ok"], clock),
                                  destination="d", sender_id="x",
                                  seq_start=1, journal=fj2, clock=clock,
                                  registry=ResilienceRegistry())
        (entry,) = fwd2._entries
        assert (entry.seq, entry.chunk_offset, entry.chunk_count) == \
            (1, 2, 3)
        assert_export_equal(entry.export, tail)
        fj2.close()

    def test_demoted_spill_tier_recovers(self, tmp_path):
        clock = FakeClock()
        fwd, _inner, fj, reg = self._mk(
            tmp_path, ["refused"], clock=clock, max_spill_intervals=2)
        for seed in range(4):           # 4 parks through a 2-entry cap
            with pytest.raises(ConnectionRefusedError):
                fwd(mk_export(seed))
        assert len(fwd._entries) == 2 and len(fwd.spill) > 0
        pending = fwd.pending_spill
        fj.close()
        fwd2, _i2, fj2, reg2 = self._mk(
            tmp_path, ["ok"], clock=clock, max_spill_intervals=2)
        assert len(fwd2._entries) == 2
        assert len(fwd2.spill) == len(fwd.spill)
        assert fwd2.pending_spill == pending
        assert reg2.peek("d", "durability.recovered_intervals") == 2
        assert reg2.peek("d", "durability.recovered_sketches") == pending
        fj2.close()

    def test_max_admitted_excludes_partially_admitted_seqs(self):
        """A partially-delivered seq must NOT become a durable
        watermark: restoring it after a receiver restart would
        permanently refuse the tail the sender is still replaying."""
        from veneur_tpu_torch.cluster.importsrv import DedupeLedger
        ledger = DedupeLedger(registry=ResilienceRegistry())
        assert ledger.admit("s", 1, 0, 1)        # complete
        assert ledger.admit("s", 2, 0, 3)        # 2 of 3 chunks only
        assert ledger.admit("s", 2, 1, 3)
        assert ledger.max_admitted() == {"s": 1}
        assert ledger.admit("s", 2, 2, 3)        # tail lands
        assert ledger.max_admitted() == {"s": 2}

    def test_journal_io_error_degrades_not_drops(self, tmp_path,
                                                 monkeypatch):
        """A failing journal (disk full, I/O error) must never cost an
        interval: the forwarder degrades to unjournaled operation —
        the pre-durability lossless contract — and counts the event."""
        clock = FakeClock()
        reg = ResilienceRegistry()
        delivered = []

        class Rec:
            def __call__(self, export, envelope=None):
                delivered.append(envelope)
        fj = ForwardJournal(str(tmp_path), fsync="never")
        fwd = ResilientForwarder(Rec(), destination="d", sender_id="sid",
                                 seq_start=1, journal=fj, clock=clock,
                                 registry=reg)

        def boom(*a, **k):
            raise OSError(28, "No space left on device")
        monkeypatch.setattr(fj.journal, "append", boom)
        fwd(mk_export(0))               # write-ahead fails -> degrade
        assert len(delivered) == 1      # ...but the interval DELIVERED
        assert fwd._journal is None     # journaling disabled, counted
        assert reg.peek("d", "durability.journal_errors") == 1
        fwd(mk_export(1))               # later ticks keep flowing
        assert len(delivered) == 2

    def test_disabled_journal_is_bit_identical_noop(self, tmp_path):
        """durability off (journal=None) must leave the forwarder's
        behavior AND the filesystem untouched."""
        before = set(os.listdir(tmp_path))
        clock = FakeClock()
        inner = ScriptedCallable(["refused", "ok", "ok"], clock)
        fwd = ResilientForwarder(inner, destination="d", sender_id="sid",
                                 seq_start=1, clock=clock,
                                 registry=ResilienceRegistry())
        with pytest.raises(ConnectionRefusedError):
            fwd(mk_export(0))
        fwd(mk_export(1))
        fwd.journal_tick()              # flush-boundary hook: no-op
        assert fwd._entries == []
        assert set(os.listdir(tmp_path)) == before
        assert [c[2] for c in inner.calls] == ["refused", "ok", "ok"]


# ------------------------------------- engine checkpoint/restore
#
# The global tier's engine-state records: codec roundtrips must be
# BIT-exact (raw-leaf framing: NaN payloads, -0.0, inf all survive),
# a checkpoint+restore cycle must flush bit-identically to the
# uncrashed engine, the delta encoding must serialize only dirty
# piles, and the torn-write/bit-flip fuzz contract extends to the new
# record kinds.

def _mk_engine(**kw):
    from veneur_tpu_torch.models.pipeline import (AggregationEngine,
                                            EngineConfig)
    cfg = dict(histogram_slots=64, counter_slots=32, gauge_slots=32,
               set_slots=16, batch_size=32, buffer_depth=32,
               hll_precision=6, percentiles=(0.5, 0.99),
               aggregates=("min", "max", "count"), is_global=True)
    cfg.update(kw)
    eng = AggregationEngine(EngineConfig(**cfg), device="cpu")
    eng.enable_dirty_tracking()
    return eng


def _feed_engine(eng, seed=0, n=6):
    rng = np.random.default_rng(seed)
    for k in range(n):
        m = int(rng.integers(2, 30))
        means = np.sort(rng.normal(50 + k, 9, m).astype(np.float32))
        weights = rng.uniform(0.5, 3.0, m).astype(np.float32)
        eng.import_histogram(
            MetricKey(f"e.h{k % 3}", "timer", "a:b"), means, weights,
            float(means.min()), float(means.max()),
            float((means * weights).sum()), float(weights.sum()),
            float(rng.uniform(0, 2)))
        eng.import_counter(MetricKey(f"e.c{k % 2}", "counter", ""),
                           float(rng.uniform(0, 100)))
        eng.import_gauge(MetricKey("e.g", "gauge", ""),
                         float(rng.normal()))
        eng.import_set(MetricKey("e.s", "set", ""),
                       rng.integers(0, 30, 1 << 6).astype(np.uint8))


def _flush_rows(eng, ts=777):
    res = eng.flush(timestamp=ts)
    return sorted(
        (m.name, tuple(m.tags), str(m.type), m.value)
        for m in res.metrics)


def _roundtrip_checkpoint(snap, engine_idx=0, n_engines=1):
    """encode -> frame -> decode, like recovery would see it."""
    recs = drec.encode_engine_checkpoint(engine_idx, n_engines, snap)
    meta = keys = None
    banks, staged = {}, {}
    keys = {}
    for rec_type, payload in recs:
        if rec_type == drec.REC_ENGINE_META:
            meta = drec.decode_engine_meta(payload)
        elif rec_type == drec.REC_ENGINE_KEYS:
            _i, kind, interval, entries = \
                drec.decode_engine_keys(payload)
            keys[kind] = (interval, entries)
        elif rec_type == drec.REC_ENGINE_BANK:
            _i, kind, ids, leaves = drec.decode_engine_bank(payload)
            banks[kind] = (ids, leaves)
        elif rec_type == drec.REC_ENGINE_STAGED:
            _i, staged = drec.decode_engine_staged(payload)
    return meta, keys, banks, staged


class TestEngineRecords:
    def test_engine_import_roundtrip_with_envelope(self):
        from veneur_tpu_torch.cluster import wire
        ms = wire.export_to_metrics(mk_export(3))
        env = ("sender-1", 42, 1, 3)
        payload = drec.encode_engine_import(9, ms, env)
        op_id, back, env2 = drec.decode_engine_import(payload)
        assert op_id == 9 and env2 == env
        assert [m.SerializeToString() for m in back] == \
            [m.SerializeToString() for m in ms]

    def test_engine_import_roundtrip_without_envelope(self):
        from veneur_tpu_torch.cluster import wire
        ms = wire.export_to_metrics(mk_export(1))
        op_id, back, env = drec.decode_engine_import(
            drec.encode_engine_import(3, ms))
        assert op_id == 3 and env is None
        assert len(back) == len(ms)

    def test_engine_meta_roundtrip(self):
        fpr = (512, 256, 256, 512, 512, 256, 1 << 14, 100.0)
        payload = drec.encode_engine_meta(2, 4, 77, 13, fpr)
        assert drec.decode_engine_meta(payload) == (2, 4, 77, 13, fpr)

    def test_engine_keys_roundtrip(self):
        entries = [(5, 1, 9, "a.b", "timer", "x:y,z:w"),
                   (0, 0, 0, "c", "counter", "")]
        payload = drec.encode_engine_keys(1, drec.BANK_HISTO, 11,
                                          entries)
        assert drec.decode_engine_keys(payload) == \
            (1, drec.BANK_HISTO, 11, entries)

    def test_engine_bank_rows_bit_exact(self):
        """Raw-leaf framing must survive every f32 bit pattern — NaN
        payloads, -0.0, inf — verified on the u32 view."""
        rng = np.random.default_rng(8)
        ids = np.array([3, 7, 50], np.int32)
        leaves = {
            "mean": rng.integers(0, 2**32, (3, 16),
                                 dtype=np.uint32).view(np.float32),
            "weight": rng.uniform(0, 5, (3, 16)).astype(np.float32),
            "buf_value": rng.normal(size=(3, 8)).astype(np.float32),
            "buf_weight": rng.uniform(0, 1, (3, 8)).astype(np.float32),
            "buf_n": rng.integers(0, 8, 3).astype(np.int32),
            "vmin": np.array([np.inf, -0.0, np.nan], np.float32),
            "vmax": np.array([-np.inf, 1e38, -1e-40], np.float32),
            "vsum": rng.normal(size=3).astype(np.float32),
            "count": rng.uniform(0, 9, 3).astype(np.float32),
            "recip": rng.normal(size=3).astype(np.float32),
            "vsum_lo": rng.normal(size=3).astype(np.float32),
            "count_lo": rng.normal(size=3).astype(np.float32),
            "recip_lo": rng.normal(size=3).astype(np.float32),
        }
        payload = drec.encode_engine_bank(0, drec.BANK_HISTO, ids,
                                          leaves)
        _i, kind, ids2, leaves2 = drec.decode_engine_bank(payload)
        assert kind == drec.BANK_HISTO
        np.testing.assert_array_equal(ids, ids2)
        for name in drec.HISTO_LEAVES:
            a, b = leaves[name], leaves2[name]
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype == np.float32:
                np.testing.assert_array_equal(a.view(np.uint32),
                                              b.view(np.uint32))
            else:
                np.testing.assert_array_equal(a, b)

    def test_engine_staged_roundtrip(self):
        rng = np.random.default_rng(4)
        staged = {
            "centroids": [
                (7, rng.normal(size=5).astype(np.float32),
                 rng.uniform(0, 2, 5).astype(np.float32),
                 1.0, 9.0, 22.5, 5.0, 0.25)],
            "sets": [(2, rng.integers(0, 40, 64).astype(np.uint8))],
            "counters": [(3, 1.0000000001), (9, -7.25)],
            "gauges": [(1, 2.5)],
        }
        _i, back = drec.decode_engine_staged(
            drec.encode_engine_staged(5, staged))
        assert back["counters"] == staged["counters"]   # exact f64
        assert back["gauges"] == staged["gauges"]
        (s, m, w, *scalars) = back["centroids"][0]
        assert s == 7 and tuple(scalars) == (1.0, 9.0, 22.5, 5.0, 0.25)
        np.testing.assert_array_equal(m, staged["centroids"][0][1])
        np.testing.assert_array_equal(w, staged["centroids"][0][2])
        np.testing.assert_array_equal(back["sets"][0][1],
                                      staged["sets"][0][1])


class TestEngineCheckpointRestore:
    def test_restore_flushes_bit_identical(self):
        """THE engine-level criterion: checkpoint an engine mid-
        interval, restore into a fresh engine, and both must flush
        bit-identical state — then keep ingesting into both and the
        NEXT flush must also match (restored rows re-marked dirty,
        staged accumulators intact)."""
        a = _mk_engine()
        _feed_engine(a, seed=1)
        snap = _roundtrip_checkpoint(a.checkpoint_state())
        meta, keys, banks, staged = snap
        _idx, _n, wm, gseq, fpr = meta
        b = _mk_engine()
        b.restore_checkpoint(fpr, gseq, wm, keys, banks, staged)
        assert _flush_rows(a) == _flush_rows(b)
        # continue the interval on both: restored state must compose
        _feed_engine(a, seed=2)
        _feed_engine(b, seed=2)
        assert _flush_rows(a, ts=778) == _flush_rows(b, ts=778)

    def test_checkpoint_after_flush_roundtrips(self):
        """The server's actual cadence: checkpoint AFTER the flush
        swap (banks mostly fresh, interner carrying the keys)."""
        a = _mk_engine()
        _feed_engine(a, seed=3)
        a.flush(timestamp=100)
        _feed_engine(a, seed=4, n=2)      # post-swap touches
        meta, keys, banks, staged = _roundtrip_checkpoint(
            a.checkpoint_state())
        _idx, _n, wm, gseq, fpr = meta
        b = _mk_engine()
        b.restore_checkpoint(fpr, gseq, wm, keys, banks, staged)
        _feed_engine(a, seed=5, n=2)
        _feed_engine(b, seed=5, n=2)
        assert _flush_rows(a) == _flush_rows(b)

    def test_delta_serializes_under_10pct_when_10pct_touched(self):
        """Acceptance gate: touch < 10% of slots, and the checkpoint
        serializes < 10% of piles — the delta encoding's whole
        point."""
        eng = _mk_engine(histogram_slots=512, counter_slots=256,
                         gauge_slots=256, set_slots=256)
        for k in range(20):               # 20/512 histo slots
            eng.import_histogram(
                MetricKey(f"d.h{k}", "timer", ""),
                np.array([1.0, 2.0], np.float32),
                np.array([1.0, 1.0], np.float32), 1.0, 2.0, 3.0, 2.0,
                1.5)
        with eng.lock:
            eng._flush_import_centroids()
        snap = eng.checkpoint_state()
        assert snap["piles_dirty"] <= 20
        assert snap["piles_total"] == 512 + 256 + 256 + 256
        assert snap["piles_dirty"] / snap["piles_total"] < 0.10
        # and the encoded records carry exactly the dirty rows
        recs = drec.encode_engine_checkpoint(0, 1, snap)
        rows = 0
        for rec_type, payload in recs:
            if rec_type == drec.REC_ENGINE_BANK:
                _i, _k, ids, _l = drec.decode_engine_bank(payload)
                rows += len(ids)
        assert rows == snap["piles_dirty"]

    def test_fingerprint_mismatch_refuses(self):
        a = _mk_engine()
        _feed_engine(a, seed=1, n=2)
        meta, keys, banks, staged = _roundtrip_checkpoint(
            a.checkpoint_state())
        _idx, _n, wm, gseq, fpr = meta
        b = _mk_engine(histogram_slots=128)    # different shape
        with pytest.raises(ValueError, match="fingerprint"):
            b.restore_checkpoint(fpr, gseq, wm, keys, banks, staged)

    def test_dirty_bitmap_resets_at_swap(self):
        eng = _mk_engine()
        _feed_engine(eng, seed=6, n=3)
        with eng.lock:
            eng._flush_import_centroids()
            eng._flush_import_sets()
        assert eng.dirty_stats()[0] > 0
        eng.flush(timestamp=50)
        assert eng.dirty_stats()[0] == 0


class TestEngineJournalFuzz:
    """The torn-write/bit-flip contract extended to the engine record
    kinds: recovery never raises and yields a bit-exact PREFIX whose
    every record still decodes."""

    def _engine_journal(self, tmp_path):
        from veneur_tpu_torch.cluster import wire
        from veneur_tpu_torch.durability import EngineJournal
        ej = EngineJournal(str(tmp_path), fsync="never")
        ej.journal.load()
        eng = _mk_engine()
        written = []
        for op in range(1, 6):
            ms = wire.export_to_metrics(mk_export(op))
            payload = drec.encode_engine_import(
                op, ms, ("s", op, 0, 1))
            ej.append_import(payload)
            written.append((drec.REC_ENGINE_IMPORT, payload))
            _feed_engine(eng, seed=op, n=2)
            recs = drec.encode_engine_checkpoint(
                0, 1, eng.checkpoint_state())
            ej.append_checkpoint(recs)
            written.extend(recs)
        ej.close()
        return ej.journal.journal_path, written

    def _decode_all(self, recs):
        for rec_type, payload in recs:
            if rec_type == drec.REC_ENGINE_IMPORT:
                drec.decode_engine_import(payload)
            elif rec_type == drec.REC_ENGINE_META:
                drec.decode_engine_meta(payload)
            elif rec_type == drec.REC_ENGINE_KEYS:
                drec.decode_engine_keys(payload)
            elif rec_type == drec.REC_ENGINE_BANK:
                drec.decode_engine_bank(payload)
            elif rec_type == drec.REC_ENGINE_STAGED:
                drec.decode_engine_staged(payload)
            elif rec_type == drec.REC_ENGINE_COMMIT:
                drec.decode_engine_commit(payload)

    def test_truncation_prefix_only(self, tmp_path):
        path, written = self._engine_journal(tmp_path)
        blob = open(path, "rb").read()
        for cut in range(HEADER_BYTES, len(blob),
                         max(1, len(blob) // 300)):
            recs, _end, _torn = decode_frames(blob[:cut], HEADER_BYTES)
            assert recs == written[:len(recs)]
            self._decode_all(recs)       # every surviving record decodes

    def test_bit_flip_prefix_only(self, tmp_path):
        path, written = self._engine_journal(tmp_path)
        blob = bytearray(open(path, "rb").read())
        rng = random.Random(17)
        for _ in range(200):
            i = rng.randrange(HEADER_BYTES, len(blob))
            bit = 1 << rng.randrange(8)
            blob[i] ^= bit
            recs, _end, torn = decode_frames(bytes(blob), HEADER_BYTES)
            assert recs == written[:len(recs)]
            if len(recs) < len(written):
                assert torn
            self._decode_all(recs)
            blob[i] ^= bit


# ==================================================================
# The two packages against each other
# ==================================================================

import veneur_tpu.durability as jdur  # noqa: E402
from veneur_tpu import resilience as jres  # noqa: E402
from veneur_tpu.cluster import wire as jwire  # noqa: E402
from veneur_tpu.durability import history as jhist  # noqa: E402
from veneur_tpu.durability import journal as jjournal  # noqa: E402
from veneur_tpu.durability import records as jrec  # noqa: E402
from veneur_tpu.ingest import parser as jparser  # noqa: E402
from veneur_tpu.models import pipeline as jpipe  # noqa: E402
from veneur_tpu_torch import resilience as tres  # noqa: E402
from veneur_tpu_torch.cluster import wire as twire  # noqa: E402
from veneur_tpu_torch.durability import history as thist  # noqa: E402
from veneur_tpu_torch.ingest import parser as tparser  # noqa: E402
from veneur_tpu_torch.models import pipeline as tpipe  # noqa: E402

PAIRS = {"tdigest+hll": {},
         "req+ull": {"histogram_backend": "req", "set_backend": "ull",
                     "req_levels": 2, "req_capacity": 32,
                     "ull_precision": 6}}


def _export_in(pkg_parser, pkg_pipeline, seed, n_keys=3, m=16):
    """mk_export's data as one package's ForwardExport (its own
    MetricKey), so the two packages encode the same interval."""
    rng = np.random.default_rng(seed)
    K = pkg_parser.MetricKey
    exp = pkg_pipeline.ForwardExport()
    for k in range(n_keys):
        n = int(rng.integers(1, 40))
        means = np.sort(rng.normal(100, 20, n).astype(np.float32))
        weights = rng.uniform(0.5, 4.0, n).astype(np.float32)
        exp.histograms.append(
            (K(f"h{k}", "timer", "a:b"), means, weights,
             float(means.min()), float(means.max()),
             float((means * weights).sum()), float(weights.sum()),
             float(rng.uniform(0, 2))))
    exp.sets.append((K(f"s{seed}", "set", ""),
                     rng.integers(0, 40, m).astype(np.uint8)))
    exp.counters.append((K("c", "counter", "x:y"),
                         float(rng.uniform(0, 100))))
    exp.gauges.append((K("g", "gauge", ""), float(rng.normal())))
    return exp


def _both_exports(seed, **kw):
    return (_export_in(jparser, jpipe, seed, **kw),
            _export_in(tparser, tpipe, seed, **kw))


class TestGoldenBytesAcrossPackages:
    """Every byte the port writes is the reference's: the checksum, the
    frames, the journal, snapshot, segment and manifest files, and every
    record kind, on the same inputs made from a seed."""

    @pytest.mark.parametrize("n", [0, 1, 9, 255, 256, 257, 4099, 65536,
                                   200003])
    def test_crc32c_equal(self, n):
        rng = np.random.default_rng(n)
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c(data) == jdur.crc32c(data)
        seed = int(rng.integers(0, 2**32))
        assert crc32c(data, seed) == jdur.crc32c(data, seed)
        assert crc32c(b"123456789") == jdur.crc32c(b"123456789") \
            == 0xE3069283

    @pytest.mark.parametrize("rec_type", list(range(1, 18)))
    def test_frame_equal(self, rec_type):
        rng = np.random.default_rng(rec_type)
        payload = rng.integers(0, 256, rec_type * 37,
                               dtype=np.uint8).tobytes()
        assert encode_frame(rec_type, payload) == \
            jjournal.encode_frame(rec_type, payload)
        blob = b"".join(encode_frame(t, payload[:t])
                        for t in range(1, rec_type + 1))
        assert decode_frames(blob) == jjournal.decode_frames(blob)

    def test_journal_and_snapshot_files_equal(self, tmp_path):
        rng = np.random.default_rng(3)
        recs = [(int(rng.integers(1, 18)),
                 rng.integers(0, 256, int(rng.integers(0, 300)),
                              dtype=np.uint8).tobytes())
                for _ in range(40)]
        files = []
        for name, J in (("ref", jdur.Journal), ("port", Journal)):
            d = tmp_path / name
            j = J(str(d), "x", fsync="never",
                  registry=ResilienceRegistry())
            j.load()
            for t, p in recs[:25]:
                j.append(t, p)
            j.snapshot(recs[25:30])
            for t, p in recs[30:]:
                j.append(t, p)
            j.close()
            files.append([open(d / f, "rb").read()
                          for f in ("x.journal", "x.snapshot")])
        assert files[0] == files[1]

    def test_forward_records_equal(self):
        jexp, texp = _both_exports(5)
        pairs = [
            (jrec.encode_meta("sender-ü", 2**40 + 7),
             drec.encode_meta("sender-ü", 2**40 + 7)),
            (jrec.encode_begin(9, 1, 3, 2, jexp, "delta"),
             drec.encode_begin(9, 1, 3, 2, texp, "delta")),
            (jrec.encode_begin(10, 0, 0, 0, jexp),
             drec.encode_begin(10, 0, 0, 0, texp)),
            (jrec.encode_done(11), drec.encode_done(11)),
            (jrec.encode_update(12, 2, 3, jexp),
             drec.encode_update(12, 2, 3, texp)),
            (jrec.encode_export(jexp), drec.encode_export(texp)),
            (jrec.encode_watermarks({"a": 1, "b": 2**50}),
             drec.encode_watermarks({"a": 1, "b": 2**50})),
        ]
        for ref, port in pairs:
            assert port == ref
        seq, off, cnt, age, back, kind = drec.decode_begin(pairs[1][0])
        assert (seq, off, cnt, age, kind) == (9, 1, 3, 2, "delta")
        assert_export_equal(back, texp)

    def test_spill_state_record_equal(self):
        spills = []
        for res, (jexp, texp) in ((jres, _both_exports(1)),
                                  (tres, _both_exports(1))):
            sp = res.SpillBuffer(registry=res.ResilienceRegistry())
            sp.spill(jexp if res is jres else texp)
            sp.spill(_export_in(jparser if res is jres else tparser,
                                jpipe if res is jres else tpipe, 2))
            spills.append(sp)
        blob = jrec.encode_spill_state(spills[0])
        assert drec.encode_spill_state(spills[1]) == blob
        sp = tres.SpillBuffer(registry=ResilienceRegistry())
        drec.decode_spill_state(blob, sp)
        assert drec.encode_spill_state(sp) == blob

    def test_engine_records_equal(self):
        rng = np.random.default_rng(8)
        jms = jwire.export_to_metrics(_both_exports(3)[0])
        tms = twire.export_to_metrics(_both_exports(3)[1])
        env = ("sender-1", 42, 1, 3)
        assert drec.encode_engine_import(9, tms, env) == \
            jrec.encode_engine_import(9, jms, env)
        assert drec.encode_engine_import(4, tms) == \
            jrec.encode_engine_import(4, jms)
        for fpr in ((512, 256, 256, 512, 512, 256, 1 << 14, 100.0),
                    (512, 64, 32, 512, 512, 256, 1 << 6, 100.0,
                     "req/1:levels=2,capacity=32", "ull/1:p=6")):
            assert drec.encode_engine_meta(2, 4, 77, 13, fpr) == \
                jrec.encode_engine_meta(2, 4, 77, 13, fpr)
        entries = [(5, 1, 9, "a.b", "timer", "x:y,z:w"),
                   (0, 0, 0, "c", "counter", "")]
        assert drec.encode_engine_keys(1, 0, 11, entries) == \
            jrec.encode_engine_keys(1, 0, 11, entries)
        ids = np.array([3, 7, 50], np.int32)
        req = {"value": rng.normal(size=(3, 64)).astype(np.float32),
               "weight": rng.uniform(0, 4, (3, 64)).astype(np.float32),
               "n": rng.integers(0, 32, (3, 2)).astype(np.int32),
               "ncomp": rng.integers(0, 9, 3).astype(np.int32)}
        for name in ("vmin", "vmax", "vsum", "count", "recip", "vsum_lo",
                     "count_lo", "recip_lo"):
            req[name] = rng.normal(size=3).astype(np.float32)
        names = tuple(req)
        assert drec.encode_engine_bank(0, 0, ids, req, names) == \
            jrec.encode_engine_bank(0, 0, ids, req, names)
        regs = {"registers": rng.integers(0, 64, (3, 64)).astype(np.uint8)}
        assert drec.encode_engine_bank(1, 3, ids, regs) == \
            jrec.encode_engine_bank(1, 3, ids, regs)
        staged = {
            "centroids": [(7, rng.normal(size=5).astype(np.float32),
                           rng.uniform(0, 2, 5).astype(np.float32),
                           1.0, 9.0, 22.5, 5.0, 0.25)],
            "sets": [(2, rng.integers(0, 40, 64).astype(np.uint8))],
            "counters": [(3, 1.0000000001), (9, -7.25)],
            "gauges": [(1, 2.5)]}
        assert drec.encode_engine_staged(5, staged) == \
            jrec.encode_engine_staged(5, staged)
        assert drec.encode_history_meta(3, 10**18, 10**17, [4, 0, 9],
                                        2, 8) == \
            jrec.encode_history_meta(3, 10**18, 10**17, [4, 0, 9], 2, 8)
        assert drec.encode_history_index(3, 5, 4, 1000) == \
            jrec.encode_history_index(3, 5, 4, 1000)
        assert [k for k in dir(drec) if k.startswith("REC_")] == \
            [k for k in dir(jrec) if k.startswith("REC_")]
        assert all(getattr(drec, k) == getattr(jrec, k)
                   for k in dir(jrec) if k.startswith(("REC_", "BANK")))

    @pytest.mark.parametrize("pair", list(PAIRS))
    def test_engine_checkpoint_records_equal(self, pair):
        """The same imports and lines into each package's engine: the
        two checkpoints hold the same records, byte for byte, but for
        the histogram bank's float leaves, which the clustering and the
        compress leave within the comparison contract (ROADMAP): there
        the slot ids and the integer leaves are exact, and the float
        leaves are checked through the flushes (TestCrossRestore)."""
        kw = {**_SMALL, **PAIRS[pair]}
        j = _jax_engine(**kw)
        t = _port_engine(**kw)
        _feed_pkg(j, jparser, 11, kw)
        _feed_pkg(t, tparser, 11, kw)
        jr = jrec.encode_engine_checkpoint(0, 1, j.checkpoint_state())
        tr = drec.encode_engine_checkpoint(0, 1, t.checkpoint_state())
        kinds = {r for r, _p in tr}
        assert {drec.REC_ENGINE_META, drec.REC_ENGINE_KEYS,
                drec.REC_ENGINE_BANK, drec.REC_ENGINE_STAGED,
                drec.REC_ENGINE_COMMIT} <= kinds
        assert [r for r, _p in tr] == [r for r, _p in jr]
        for (rt, tp), (_r, jp) in zip(tr, jr):
            if rt != drec.REC_ENGINE_BANK or tp[4] != drec.BANK_HISTO:
                assert tp == jp, rt
                continue
            names = t.bank_leaf_names(drec.BANK_HISTO)
            _i, _k, tids, tl = drec.decode_engine_bank(tp, lambda k: names)
            _i, _k, jids, jl = jrec.decode_engine_bank(jp, lambda k: names)
            np.testing.assert_array_equal(tids, jids)
            for name in names:
                assert tl[name].dtype == jl[name].dtype
                assert tl[name].shape == jl[name].shape
                if tl[name].dtype != np.float32:
                    np.testing.assert_array_equal(tl[name], jl[name])

    def test_history_files_equal(self, tmp_path):
        jexp, texp = _both_exports(4)
        base = [(drec.REC_ENGINE_META, drec.encode_engine_meta(
            0, 1, 0, 0, (64, 32, 32, 32, 32, 16, 64, 100.0))),
            (drec.REC_ENGINE_COMMIT, struct.pack("<I", 0))]
        ops = [(i, drec.encode_engine_import(
            i, twire.export_to_metrics(texp))) for i in (1, 2)]
        out = []
        for name, HS in (("ref", jhist.HistoryStore),
                         ("port", thist.HistoryStore)):
            d = tmp_path / name
            st = HS(str(d), retention_generations=2, fsync=False,
                    registry=ResilienceRegistry())
            st.append(10 * 10**9, 0, [2], base, ops)
            st.append_empty(20 * 10**9, 10 * 10**9)
            st.append_empty(30 * 10**9, 20 * 10**9)
            st.append(40 * 10**9, 30 * 10**9, [2], base, ops[1:])
            out.append({f: open(d / f, "rb").read()
                        for f in sorted(os.listdir(d))})
        assert out[0] == out[1]
        assert len(out[1]) == 2          # one segment, the manifest


# ------------------------------------------------------- cross-restore

_SMALL = dict(histogram_slots=64, counter_slots=32, gauge_slots=32,
              set_slots=16, batch_size=32, buffer_depth=32,
              hll_precision=6, percentiles=(0.5, 0.99),
              aggregates=("min", "max", "count"), is_global=True)


def _jax_engine(**kw):
    eng = jpipe.AggregationEngine(jpipe.EngineConfig(**kw))
    eng.enable_dirty_tracking()
    return eng


def _port_engine(**kw):
    eng = tpipe.AggregationEngine(tpipe.EngineConfig(**kw),
                                  device="cpu")
    eng.enable_dirty_tracking()
    return eng


def _feed_pkg(eng, pkg_parser, seed, kw, n=6):
    """Imports (landed and staged) and DogStatsD lines through one
    package's engine: the same calls on either package."""
    rng = np.random.default_rng(seed)
    K = pkg_parser.MetricKey
    m = 1 << (kw.get("ull_precision", 13)
              if kw.get("set_backend") == "ull"
              else kw.get("hll_precision", 14))
    for k in range(n):
        c = int(rng.integers(2, 30))
        means = np.sort(rng.normal(50 + k, 9, c).astype(np.float32))
        weights = np.round(rng.uniform(0.5, 3.0, c)).astype(np.float32)
        eng.import_histogram(
            K(f"e.h{k % 3}", "timer", "a:b"), means, weights,
            float(means.min()), float(means.max()),
            float((means * weights).sum()), float(weights.sum()),
            float(rng.uniform(0, 2)))
        eng.import_counter(K(f"e.c{k % 2}", "counter", ""),
                           float(rng.integers(0, 100)))
        eng.import_gauge(K("e.g", "gauge", ""), float(rng.normal()))
        eng.import_set(K("e.s", "set", ""),
                       rng.integers(0, 30, m).astype(np.uint8))
        if k == 2:
            with eng.lock:
                eng._flush_import_centroids()
                eng._flush_import_sets()
    for i in range(40):
        for line in (b"u.t%d:%d|ms" % (i % 4, rng.integers(1, 500)),
                     b"u.c%d:%d|c" % (i % 3, rng.integers(1, 9)),
                     b"u.g:%d|g" % rng.integers(-50, 50),
                     b"u.s:m%d|s" % rng.integers(0, 200)):
            eng.process(pkg_parser.parse_packet(line))
    eng.drain_all()


def _rows(res):
    return {(m.name, tuple(m.tags), str(m.type)): float(m.value)
            for m in res.metrics}


def _assert_contract(ref, port, kw):
    """ROADMAP's comparison contract on two flushes of the same state:
    the same rows; count/min/max, counters and gauges exact; quantiles
    within 1% of the key's min-max spread (t-digest) or rtol 1e-4
    (REQ); set estimates within rtol 1e-5 (HLL) or exact (ULL)."""
    assert set(ref) == set(port)
    req = kw.get("histogram_backend") == "req"
    ull = kw.get("set_backend") == "ull"
    for key, rv in ref.items():
        name, tags, _t = key
        pv = port[key]
        if name.endswith("percentile"):
            base = name.rsplit(".", 1)[0]
            if req:
                assert pv == pytest.approx(rv, rel=1e-4), key
            else:
                spread = (ref[(base + ".max", tags, _t)]
                          - ref[(base + ".min", tags, _t)])
                assert abs(pv - rv) <= 0.01 * spread + 1e-6, key
        elif name in ("e.s", "u.s") and not ull:
            assert pv == pytest.approx(rv, rel=1e-5), key
        else:
            assert pv == rv, key


def _decode_group(rec_mod, recs, leaf_names_of):
    banks, staged, keys = {}, {}, {}
    meta = None
    for rec_type, payload in recs:
        if rec_type == rec_mod.REC_ENGINE_META:
            meta = rec_mod.decode_engine_meta(payload)
        elif rec_type == rec_mod.REC_ENGINE_KEYS:
            _i, kind, interval, entries = \
                rec_mod.decode_engine_keys(payload)
            keys[kind] = (interval, entries)
        elif rec_type == rec_mod.REC_ENGINE_BANK:
            _i, kind, ids, leaves = rec_mod.decode_engine_bank(
                payload, leaf_names_of=leaf_names_of)
            banks[kind] = (ids, leaves)
        elif rec_type == rec_mod.REC_ENGINE_STAGED:
            _i, staged = rec_mod.decode_engine_staged(payload)
    _idx, _n, wm, gseq, fpr = meta
    return fpr, gseq, wm, keys, banks, staged


def _through_journal(j_cls, tmp, recs):
    """Append a checkpoint group through one package's EngineJournal
    and load it back, as recovery would read it."""
    ej = j_cls(str(tmp), fsync="never", registry=ResilienceRegistry())
    ej.load_records()
    ej.append_checkpoint(recs)
    ej.close()
    ej2 = j_cls(str(tmp), fsync="never", registry=ResilienceRegistry())
    out = ej2.load_records()
    ej2.close()
    return out


class TestCrossRestore:
    @pytest.mark.parametrize("pair", list(PAIRS))
    def test_reference_checkpoint_restores_in_the_port(self, pair,
                                                       tmp_path):
        from veneur_tpu_torch.durability import EngineJournal
        kw = {**_SMALL, **PAIRS[pair]}
        j = _jax_engine(**kw)
        _feed_pkg(j, jparser, 21, kw)
        recs = _through_journal(
            jdur.EngineJournal, tmp_path / "ref",
            jrec.encode_engine_checkpoint(0, 1, j.checkpoint_state()))
        t = _port_engine(**kw)
        # the port's journal reads the reference's file as its own
        assert _through_journal(EngineJournal, tmp_path / "ref", []) \
            == recs
        t.restore_checkpoint(*_decode_group(drec, recs,
                                            t.bank_leaf_names))
        # restored and re-taken, the port's checkpoint is the same bytes
        assert drec.encode_engine_checkpoint(0, 1, t.checkpoint_state()) \
            == recs
        _assert_contract(_rows(j.flush(timestamp=5)),
                         _rows(t.flush(timestamp=5)), kw)

    @pytest.mark.parametrize("pair", list(PAIRS))
    def test_port_checkpoint_restores_in_the_reference(self, pair,
                                                       tmp_path):
        from veneur_tpu_torch.durability import EngineJournal
        kw = {**_SMALL, **PAIRS[pair]}
        t = _port_engine(**kw)
        _feed_pkg(t, tparser, 22, kw)
        t.flush(timestamp=4)               # a boundary, then more state
        _feed_pkg(t, tparser, 23, kw, n=3)
        recs = _through_journal(
            EngineJournal, tmp_path / "port",
            drec.encode_engine_checkpoint(0, 1, t.checkpoint_state()))
        j = _jax_engine(**kw)
        j.restore_checkpoint(*_decode_group(jrec, recs,
                                            j.bank_leaf_names))
        assert jrec.encode_engine_checkpoint(0, 1, j.checkpoint_state()) \
            == recs
        _assert_contract(_rows(j.flush(timestamp=5)),
                         _rows(t.flush(timestamp=5)), kw)

    @pytest.mark.parametrize("direction", ["ref->port", "port->ref"])
    def test_fingerprint_mismatch_refused_both_ways(self, direction):
        """A checkpoint of another shape, or of the other engine pair,
        is refused loudly by either package's engine."""
        kw = {**_SMALL}
        if direction == "ref->port":
            src = _jax_engine(**kw)
            _feed_pkg(src, jparser, 3, kw, n=2)
            recs = jrec.encode_engine_checkpoint(
                0, 1, src.checkpoint_state())
            targets = (_port_engine(**{**kw, "histogram_slots": 128}),
                       _port_engine(**{**kw, **PAIRS["req+ull"]}))
            dec = drec
        else:
            src = _port_engine(**kw)
            _feed_pkg(src, tparser, 3, kw, n=2)
            recs = drec.encode_engine_checkpoint(
                0, 1, src.checkpoint_state())
            targets = (_jax_engine(**{**kw, "histogram_slots": 128}),
                       _jax_engine(**{**kw, **PAIRS["req+ull"]}))
            dec = jrec
        for tgt in targets:
            args = _decode_group(dec, recs, None)
            with pytest.raises(ValueError, match="fingerprint"):
                tgt.restore_checkpoint(*args)


class TestPortRestoreBitIdentity:
    @pytest.mark.parametrize("pair", list(PAIRS))
    def test_restored_engine_flushes_like_its_uncrashed_twin(self, pair,
                                                             tmp_path):
        """Within the port the bar is bit-identity: a restored engine
        and its uncrashed twin flush the same bytes, this interval and
        the next (restored rows re-marked dirty, staged imports kept)."""
        from veneur_tpu_torch.durability import EngineJournal
        kw = {**_SMALL, **PAIRS[pair]}
        a = _port_engine(**kw)
        _feed_pkg(a, tparser, 31, kw)
        a.flush(timestamp=1)
        _feed_pkg(a, tparser, 32, kw)
        recs = _through_journal(
            EngineJournal, tmp_path,
            drec.encode_engine_checkpoint(0, 1, a.checkpoint_state()))
        b = _port_engine(**kw)
        b.restore_checkpoint(*_decode_group(drec, recs,
                                            b.bank_leaf_names))
        assert _flush_rows(a, ts=2) == _flush_rows(b, ts=2)
        _feed_pkg(a, tparser, 33, kw)
        _feed_pkg(b, tparser, 33, kw)
        assert _flush_rows(a, ts=3) == _flush_rows(b, ts=3)

    def test_gather_and_whole_leaf_fetch_agree(self):
        """Past the delta threshold the checkpoint fetches whole leaves
        and slices them on the host; below it, it gathers rows on the
        device. Both give the same records."""
        kw = dict(_SMALL)
        a = _port_engine(**kw)
        _feed_pkg(a, tparser, 41, kw)
        a.enable_dirty_tracking(1.0)      # every fetch a gather
        gathered = drec.encode_engine_checkpoint(0, 1,
                                                 a.checkpoint_state())
        a.enable_dirty_tracking(1e-9)     # every fetch a whole leaf
        whole = drec.encode_engine_checkpoint(0, 1, a.checkpoint_state())
        assert gathered == whole

    def test_dirty_tracking_arms_without_the_incremental_flush(self):
        eng = tpipe.AggregationEngine(
            tpipe.EngineConfig(**_SMALL, flush_incremental=False),
            device="cpu")
        assert eng._dirty is None and eng.dirty_stats() == (0, 0)
        eng.enable_dirty_tracking()
        _feed_pkg(eng, tparser, 5, _SMALL, n=3)
        dirty, total = eng.dirty_stats()
        assert 0 < dirty < total == 64 + 32 + 32 + 16
        marks = [d.copy() for d in eng._dirty]
        eng.enable_dirty_tracking(0.25)   # re-arming keeps the marks
        assert all((a == b).all() for a, b in zip(marks, eng._dirty))
        snap = eng.checkpoint_state()
        assert snap["piles_dirty"] == dirty
