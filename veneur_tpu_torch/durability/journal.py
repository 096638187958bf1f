"""The storage layer: append-only CRC32C-framed record journal — the
port's copy of veneur_tpu/durability/journal.py, byte for byte the same
files.

On-disk layout (all integers little-endian):

    journal file:   MAGIC ("VTPUJRN1", 8 bytes) | u64 generation
                    | frames
    snapshot file:  SNAP_MAGIC ("VTPUSNP1", 8 bytes) | u64 generation
                    | frames
    frame:          u32 length | u32 crc32c | u8 rec_type | payload
                    where length = 1 + len(payload) (the type byte is
                    part of the framed body) and the CRC covers
                    type byte + payload.

The generation is what makes snapshot+compaction atomic END TO END: a
snapshot is written with generation G+1, renamed into place, and only
then is the journal truncated and restamped to G+1. A crash between
the rename and the truncate leaves a G+1 snapshot next to a G journal
whose records are ALREADY folded into the snapshot — recovery sees
journal_generation < snapshot_generation and drops the stale journal
records instead of double-applying them (counted, logged).

Torn-write tolerance: a crash can leave a partial frame at the tail
(power loss mid-write) or, in the worst case, a bit flip anywhere in
the unsynced tail. Recovery reads frames until the first one whose
header is incomplete, whose length is implausible, or whose CRC
mismatches — everything from that offset on is discarded and the file
is truncated back to the last good frame when reopened for append
(`truncated_frames_total` counts the events). Recovery therefore NEVER
raises on a corrupt journal and never invents records: a frame is
either returned bit-exact or dropped with everything after it.

Fsync policy (`always` / `interval` / `never`): every append pushes
bytes to the OS (so a process kill loses nothing that was appended —
only power loss can), and `always` additionally fsyncs per append,
`interval` at most once per `fsync_interval_s` (plus at every `sync()`
— the server calls it on the flush boundary), `never` leaves syncing
to the kernel.

Snapshot + compaction is atomic: the full state is written to a temp
file, fsynced, `os.replace`d over the snapshot, the directory entry
fsynced, and only THEN is the journal truncated — a crash at any point
leaves either the old (snapshot, journal) pair or the new one, never a
mix with holes.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time

log = logging.getLogger("veneur_tpu_torch.durability")

MAGIC = b"VTPUJRN1"
SNAP_MAGIC = b"VTPUSNP1"
_GEN = struct.Struct("<Q")              # file generation, after the magic
HEADER_BYTES = len(MAGIC) + _GEN.size   # magic + generation
_HEADER = struct.Struct("<II")          # frame length, crc32c
# a frame longer than this is treated as corruption, not a record —
# bounds what a flipped length field can make recovery try to read
MAX_FRAME_BYTES = 1 << 30

FSYNC_POLICIES = ("always", "interval", "never")


def _make_crc32c_table():
    poly = 0x82F63B78                   # Castagnoli, reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC32C_TABLE = _make_crc32c_table()


def _crc32c_scalar(data: bytes, crc: int = 0) -> int:
    """Reference byte-at-a-time implementation (and the fast path for
    short inputs, where the vector setup would dominate)."""
    table = _CRC32C_TABLE
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ table[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


# --- vectorized CRC-32C -----------------------------------------------
#
# The flush tick CRCs the whole serialized interval (hundreds of KB);
# the byte loop above runs ~4 MB/s in CPython, which would make the
# checksum THE cost of durability. CRC is
# linear over GF(2), which buys a numpy formulation:
#
#   * split the message into L 64-byte lanes and run the byte loop over
#     the LANE axis — 64 numpy iterations, each processing one byte
#     column of every lane at once;
#   * fold the L per-lane registers together in log2(L) rounds, where
#     "advance register x across m zero bytes" is a linear map applied
#     via four 256-entry uint32 tables (one per register byte);
#   * the advance tables for m = 2^j bytes are built once by composing
#     the 1-byte map with itself, and cached process-wide.
#
# Front-padding with zero bytes is free (a zero register stays zero
# through zero bytes), so the message is padded to a power-of-two lane
# count and the fold needs no odd-lane special case.

_LANE = 64          # bytes per lane in the columnwise pass
_ADV_LEVELS: list = []       # _ADV_LEVELS[j]: uint32[4,256], advance 2^j bytes
_ADV_LOCK = threading.Lock() # appends to _ADV_LEVELS must be ordered


def _apply_adv(tables, vals):
    """Apply a 4-table advance map to uint32 values (scalar or array)."""
    import numpy as _np
    v = _np.asarray(vals, _np.uint32)
    return (tables[0][v & 0xFF]
            ^ tables[1][(v >> 8) & 0xFF]
            ^ tables[2][(v >> 16) & 0xFF]
            ^ tables[3][(v >> 24) & 0xFF])


def _adv_level(j: int):
    """Advance-by-2^j-bytes tables, built lazily and cached (under a
    lock: a racing pair of builders appending out of order would
    assign the wrong span to a level)."""
    import numpy as _np
    if j < len(_ADV_LEVELS):             # fast path, append-only list
        return _ADV_LEVELS[j]
    with _ADV_LOCK:
        if not _ADV_LEVELS:
            # level 0: advance one byte. For the low register byte b
            # the next state is TABLE[b]; a byte at position p>0 just
            # shifts down 8 bits (its low byte is 0 and TABLE[0] == 0).
            b = _np.arange(256, dtype=_np.uint32)
            t0 = _np.array(_CRC32C_TABLE, _np.uint32)
            _ADV_LEVELS.append(_np.stack([t0, b, b << 8, b << 16]))
        while len(_ADV_LEVELS) <= j:
            cur = _ADV_LEVELS[-1]
            _ADV_LEVELS.append(_np.stack(
                [_apply_adv(cur, cur[p]) for p in range(4)]))
        return _ADV_LEVELS[j]


def _advance(crc: int, n_bytes: int) -> int:
    """Advance a raw register across n zero bytes (binary decompose)."""
    j = 0
    while n_bytes:
        if n_bytes & 1:
            crc = int(_apply_adv(_adv_level(j), crc))
        n_bytes >>= 1
        j += 1
    return crc


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) — the checksum the storage world uses for
    record framing (iSCSI, ext4, leveldb); stdlib zlib only ships the
    IEEE polynomial. Short inputs take the table loop; long ones the
    vectorized lane fold (bit-identical: tests pin both against the
    published check value and each other)."""
    n = len(data)
    if n < 4 * _LANE:
        return _crc32c_scalar(data, crc)
    import numpy as np
    lanes = 1 << max(0, (n - 1).bit_length() - 6)   # pow2 >= n/64
    total = lanes * _LANE
    buf = np.zeros(total, np.uint8)
    # vlint: disable=DR02 reason=CRC lane fold reads the frame bytes as
    # u8 lanes for checksumming — not an engine-state codec
    buf[total - n:] = np.frombuffer(data, np.uint8)  # front zero-pad
    cols = buf.reshape(lanes, _LANE)
    t0 = np.array(_CRC32C_TABLE, np.uint32)
    reg = np.zeros(lanes, np.uint32)
    for jcol in range(_LANE):
        reg = (reg >> 8) ^ t0[(reg ^ cols[:, jcol]) & 0xFF]
    # log-depth fold: advance the left lane across the right lane's span
    level = 6                                        # 2^6 = _LANE bytes
    while len(reg) > 1:
        tables = _adv_level(level)
        reg = _apply_adv(tables, reg[0::2]) ^ reg[1::2]
        level += 1
    raw = int(reg[0])
    init = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    return (raw ^ _advance(init, n)) ^ 0xFFFFFFFF


def encode_frame(rec_type: int, payload: bytes) -> bytes:
    body = bytes([rec_type]) + payload
    return _HEADER.pack(len(body), crc32c(body)) + body


def decode_frames(data: bytes, offset: int = 0):
    """Parse frames from `data[offset:]`. Returns
    (records, good_end_offset, truncated) where records is a list of
    (rec_type, payload) and truncated is True when a bad/partial frame
    stopped the scan before the end of the buffer."""
    records = []
    n = len(data)
    while True:
        if offset + _HEADER.size > n:
            return records, offset, offset != n
        length, crc = _HEADER.unpack_from(data, offset)
        start = offset + _HEADER.size
        if length < 1 or length > MAX_FRAME_BYTES or start + length > n:
            return records, offset, True
        body = data[start:start + length]
        if crc32c(body) != crc:
            return records, offset, True
        records.append((body[0], body[1:]))
        offset = start + length


def read_framed_file(path: str, magic: bytes):
    """Read one framed file (journal/snapshot/history segment/manifest):
    (records, generation, good_end_offset, truncated). A missing,
    short, or wrong-magic file reads as empty with generation -1
    (unknown); a torn tail stops the scan at the last good frame.
    Never raises on corruption — the shared recovery contract."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], -1, 0, False
    header = len(magic) + _GEN.size
    if len(data) < header or data[:len(magic)] != magic:
        # not ours / torn before the header finished: treat as empty,
        # flag it if there were bytes to lose
        return [], -1, 0, bool(data)
    (gen,) = _GEN.unpack_from(data, len(magic))
    records, end, truncated = decode_frames(data, header)
    return records, gen, end, truncated


def write_framed_file(path: str, magic: bytes, generation: int,
                      records, fsync: bool = True) -> int:
    """Atomically (re)write one framed file: write-temp, fsync,
    os.replace, fsync the directory — the same publish discipline as
    Journal.snapshot, shared by the history tier's segment and
    manifest writes (durability/history.py), which is why the raw file
    I/O lives HERE (journal.py owns the framing/fsync/atomic-rename
    contract). A crash at any point leaves either the
    old file or the new one, never a torn mix. Returns bytes written."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(magic + _GEN.pack(int(generation)))
        for rec_type, payload in records:
            f.write(encode_frame(rec_type, payload))
        f.flush()
        if fsync:
            os.fsync(f.fileno())
        nbytes = f.tell()
    os.replace(tmp, path)
    if fsync:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    return nbytes


class Journal:
    """One named journal + snapshot pair inside a durability directory.

    Lifecycle: construct, `load()` once to recover state (returns the
    snapshot's records and the journal's records, in write order), then
    `append()`/`sync()` during serving and `snapshot()` at compaction
    points. `load()` also truncates any torn tail so the append cursor
    starts at the last good frame. Thread-safe: appends from gRPC
    handler threads and the flusher interleave under one lock."""

    def __init__(self, directory: str, name: str,
                 fsync: str = "interval", fsync_interval_s: float = 1.0,
                 clock=time.monotonic, registry=None,
                 destination: str = "durability"):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy must be one of {FSYNC_POLICIES}, "
                f"got {fsync!r}")
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.journal_path = os.path.join(directory, name + ".journal")
        self.snapshot_path = os.path.join(directory, name + ".snapshot")
        # exclusivity: two processes appending to one journal corrupt
        # each other silently (interleaved frames fail CRC and recovery
        # truncates them away as "torn") — so each journal holds an
        # advisory flock for its lifetime and a second opener fails
        # LOUDLY. A real SIGKILL releases the lock with the fd; the
        # in-process kill simulations release it via release_lock().
        self._lock_f = None
        try:
            import fcntl
        except ImportError:          # pragma: no cover - non-unix
            fcntl = None
        if fcntl is not None:
            self._lock_f = open(os.path.join(directory, name + ".lock"),
                                "a+b")
            try:
                fcntl.flock(self._lock_f.fileno(),
                            fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                self._lock_f.close()
                self._lock_f = None
                raise RuntimeError(
                    f"durability journal {name!r} in {directory} is "
                    "already locked by a live process — two appenders "
                    "on one journal corrupt each other; point each "
                    "server at its own durability_dir") from None
        self.fsync_policy = fsync
        self.fsync_interval_s = fsync_interval_s
        self._clock = clock
        if registry is None:
            # the unified telemetry spine (observe/registry.py) — the
            # same process-default instance resilience re-exports
            from ..observe.registry import DEFAULT_REGISTRY
            registry = DEFAULT_REGISTRY
        self._registry = registry
        self._destination = destination
        self._lock = threading.RLock()
        self._f = None
        self._generation = 0
        self._last_fsync = clock()
        self.last_snapshot_ns = 0       # duration of the last snapshot

    # ------------------------------------------------------------ load

    def _read_validated(self, path: str, magic: bytes):
        """(records, generation, good_length, truncated) for one framed
        file; a missing/short/wrong-magic file reads as empty with
        generation -1 (unknown)."""
        return read_framed_file(path, magic)

    def load(self):
        """Recover: returns (snapshot_records or None, journal_records).
        Truncates the journal's torn tail on disk and opens it for
        append, so every later `append()` lands after the last good
        frame. A journal whose generation predates the snapshot's was
        already folded into it (the crash hit between the snapshot
        rename and the journal truncate) — its records are dropped
        whole, not double-applied. Never raises on corruption — bad
        frames and everything after them are dropped, counted in
        truncated_frames_total."""
        with self._lock:
            snap_records, snap_gen, _end, snap_torn = \
                self._read_validated(self.snapshot_path, SNAP_MAGIC)
            jrn_records, jrn_gen, good_end, jrn_torn = \
                self._read_validated(self.journal_path, MAGIC)
            for torn, path in ((snap_torn, self.snapshot_path),
                               (jrn_torn, self.journal_path)):
                if torn:
                    self._registry.incr(self._destination,
                                        "durability.truncated_frames")
                    log.warning(
                        "durability: torn/corrupt frame in %s; "
                        "truncating to last good record", path)
            snapshot = snap_records if snap_gen >= 0 and snap_records \
                else None
            if snapshot is not None and jrn_gen < snap_gen:
                # stale journal: its ops are already inside the
                # snapshot; replaying both would double-apply
                self._registry.incr(self._destination,
                                    "durability.stale_journal_dropped")
                log.warning(
                    "durability: journal %s generation %d predates "
                    "snapshot generation %d (crash between snapshot "
                    "rename and truncate); dropping %d already-"
                    "compacted record(s)", self.journal_path, jrn_gen,
                    snap_gen, len(jrn_records))
                jrn_records = []
                good_end = 0       # restamp the journal below
            self._generation = max(snap_gen, jrn_gen, 0)
            # open for append at the last good offset (creates + writes
            # the header when the file is new, torn inside the header,
            # or stale)
            if good_end < HEADER_BYTES:
                self._f = open(self.journal_path, "wb")
                self._f.write(MAGIC + _GEN.pack(self._generation))
            else:
                self._f = open(self.journal_path, "r+b")
                self._f.truncate(good_end)
                self._f.seek(good_end)
            self._f.flush()
            if self.fsync_policy != "never":
                os.fsync(self._f.fileno())
            return snapshot, jrn_records

    # ---------------------------------------------------------- append

    def _ensure_open(self):
        if self._f is None:
            raise RuntimeError(
                "Journal.load() must run before append() — recovery "
                "truncates the torn tail the append cursor depends on")

    def append(self, rec_type: int, payload: bytes):
        with self._lock:
            self._ensure_open()
            frame = encode_frame(rec_type, payload)
            self._f.write(frame)
            # always push to the OS: a process kill then loses nothing
            # that was appended; fsync policy only governs power loss
            self._f.flush()
            if self.fsync_policy == "always":
                os.fsync(self._f.fileno())
                self._last_fsync = self._clock()
            elif self.fsync_policy == "interval":
                now = self._clock()
                if now - self._last_fsync >= self.fsync_interval_s:
                    os.fsync(self._f.fileno())
                    self._last_fsync = now
            self._registry.incr(self._destination,
                                "durability.journal_appends")
        return len(frame)

    def sync(self):
        """Flush + fsync now (flush-boundary / shutdown hook); a no-op
        for policy `never` beyond pushing buffered bytes to the OS."""
        with self._lock:
            if self._f is None:
                return
            self._f.flush()
            if self.fsync_policy != "never":
                os.fsync(self._f.fileno())
                self._last_fsync = self._clock()

    def size_bytes(self) -> int:
        with self._lock:
            if self._f is None:
                try:
                    return os.path.getsize(self.journal_path)
                except OSError:
                    return 0
            return self._f.tell()

    # -------------------------------------------------------- snapshot

    def snapshot(self, records) -> int:
        """Atomically replace the snapshot with `records` (a list of
        (rec_type, payload)) and truncate the journal: write-temp,
        fsync, rename, fsync the directory, THEN truncate + restamp.
        The snapshot carries generation G+1 while the journal still
        says G until the truncate lands, so a crash anywhere inside
        this sequence recovers to either (old snapshot + full journal)
        or (new snapshot + empty-or-dropped journal) — never a
        double-application. Returns the snapshot duration in ns (the
        veneur.durability.snapshot_duration gauge)."""
        with self._lock:
            self._ensure_open()
            t0 = time.monotonic_ns()
            new_gen = self._generation + 1
            tmp = self.snapshot_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(SNAP_MAGIC + _GEN.pack(new_gen))
                for rec_type, payload in records:
                    f.write(encode_frame(rec_type, payload))
                f.flush()
                if self.fsync_policy != "never":
                    os.fsync(f.fileno())
            os.replace(tmp, self.snapshot_path)
            if self.fsync_policy != "never":
                # the rename must be durable BEFORE the journal shrinks,
                # or a crash between the two leaves neither
                dfd = os.open(self.directory, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            self._f.seek(0)
            self._f.truncate(0)
            self._f.write(MAGIC + _GEN.pack(new_gen))
            self._f.flush()
            self._generation = new_gen
            if self.fsync_policy != "never":
                os.fsync(self._f.fileno())
                self._last_fsync = self._clock()
            self.last_snapshot_ns = time.monotonic_ns() - t0
            self._registry.incr(self._destination,
                                "durability.snapshots")
            return self.last_snapshot_ns

    def release_lock(self):
        """Drop the advisory process lock WITHOUT flushing or closing
        the journal — what a real SIGKILL does to the fd. Exists for
        the kill-restart simulations (utils.faults.kill_journal_lock);
        production code never calls it."""
        with self._lock:
            if self._lock_f is not None:
                self._lock_f.close()
                self._lock_f = None

    def close(self):
        with self._lock:
            if self._f is not None:
                self.sync()
                self._f.close()
                self._f = None
            self.release_lock()
