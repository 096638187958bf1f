"""ctypes bindings and pump for the C++ ingest bridge (native/vtpu_ingest.cpp).

The bridge is the native front half of ingest (server.go sym:
Server.ReadMetricSocket x num_readers on SO_REUSEPORT sockets;
samplers/parser.go sym: ParseMetric; the digest-sharded dispatch of
worker.go): C++ reader threads parse DogStatsD lines (and, on the native
SSF path, span datagrams), intern MetricKeys to bank slots, and stage
(slot, value, weight) samples in per-bank rings. Python only polls
batches and lands them in the engine's banks on its device.

Pieces here:
  * build()/load(): compile the unchanged native/vtpu_ingest.cpp with g++
    into veneur_tpu_torch/_build/ (once, at first use) and dlopen it.
  * NativeBridge: the raw C API, numpy-typed.
  * BridgeKeyView: one bridge bank behind the KeyInterner interface the
    engine's flush reads (active_items, all_items, scope_of, key_of,
    lookup, advance_interval, dropped_no_slot), so
    AggregationEngine.flush works unchanged on top of C++ interning.
  * NativePump: the polling thread. It drains the sample rings into the
    engine's ingest_*_batch methods, keeps the slot-to-key mirrors
    fresh, and routes slow-path lines (events, service checks, CPython
    float oddities, invalid UTF-8) and STATUS-carrying span datagrams
    to the Python paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import struct
import subprocess
import tempfile
import threading
import time

import numpy as np

from ..ingest.parser import MetricKey
from ..models.worker import SlotInfo

log = logging.getLogger(__name__)

_BANKS = {"histo": 0, "counter": 1, "gauge": 2, "set": 3}
# native/vtpu_ingest.cpp's RING_WAYS: a bank's ring is this many sub-rings
# of ring_capacity / RING_WAYS + 1 samples, and each writer thread keeps
# to one of them
RING_WAYS = 8
# the pump's span ring (the flight recorder's "pump" ring): a cycle that
# moved samples, the samples it moved from each bank and the ns it waited
# for the engine lock
PUMP_FIELDS = ("histo", "counter", "gauge", "set", "lock_wait_ns")
PUMP_SPANS = 1 << 16
_MTYPE_NAMES = ["counter", "gauge", "timer", "histogram", "set"]

P_METRIC, P_ERROR, P_OTHER = 0, 1, 2

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "vtpu_ingest.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libvtpu_ingest.so")
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread",
             "-shared")

_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def build(force: bool = False) -> str:
    """Compile the bridge into BUILD_DIR if it is missing or older than
    its source; returns the library's path. Concurrent builds (test
    workers, several processes) serialize on a lock file, and each
    writes a temporary file that replaces the library whole."""
    if not os.path.exists(SOURCE):
        raise NativeUnavailable(f"source missing: {SOURCE}")

    def stale():
        return force or not os.path.exists(LIB_PATH) or (
            os.path.getmtime(LIB_PATH) < os.path.getmtime(SOURCE))

    if not stale():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".libvtpu_ingest.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not stale():   # another process built it while we waited
            return LIB_PATH
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            try:
                proc = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp],
                                      capture_output=True, text=True)
            except OSError as e:
                raise NativeUnavailable(f"native build failed: {e}") from e
            if proc.returncode != 0:
                raise NativeUnavailable(
                    f"native build failed:\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The bridge library, built on first use. Loaded RTLD_LOCAL (ctypes'
    default): its vtpu_* symbols stay private to it, so another copy of
    the bridge in the same process keeps its own."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        # point the whole process at another build of the bridge, such as
        # native/Makefile's ThreadSanitizer one (`make -C native tsan`)
        path = os.environ.get("VENEUR_TPU_NATIVE_LIB") or build()
        try:
            # vlint: disable=HK01 reason=the host C++ ingest bridge
            # (native/vtpu_ingest.cpp, built by g++): CPU code with no
            # device kernel, so kernels/ does not own it
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NativeUnavailable(f"cannot load {path}: {e}") from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.vtpu_create.restype = ctypes.c_void_p
        lib.vtpu_create.argtypes = [ctypes.c_int32] * 8
        lib.vtpu_destroy.argtypes = [ctypes.c_void_p]
        lib.vtpu_handle_packet.argtypes = [ctypes.c_void_p, u8p,
                                           ctypes.c_int32]
        # c_char_p: ctypes passes the bytes object's buffer itself
        # (read-only, no copy); this call is per datagram on the SSF path
        lib.vtpu_handle_ssf.restype = ctypes.c_int32
        lib.vtpu_handle_ssf.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int32]
        lib.vtpu_set_indicator_timer.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_char_p]
        lib.vtpu_start_udp.restype = ctypes.c_int32
        lib.vtpu_start_udp.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_int32]
        lib.vtpu_start_ssf_udp.restype = ctypes.c_int32
        lib.vtpu_start_ssf_udp.argtypes = [ctypes.c_void_p,
                                           ctypes.c_char_p,
                                           ctypes.c_int32, ctypes.c_int32,
                                           ctypes.c_int32, ctypes.c_int32]
        lib.vtpu_drain_ssf_other.restype = ctypes.c_int32
        lib.vtpu_drain_ssf_other.argtypes = [ctypes.c_void_p, u8p,
                                             ctypes.c_int32]
        lib.vtpu_ssf_bound_port.restype = ctypes.c_int32
        lib.vtpu_ssf_bound_port.argtypes = [ctypes.c_void_p]
        lib.vtpu_stop.argtypes = [ctypes.c_void_p]
        lib.vtpu_poll.restype = ctypes.c_int32
        lib.vtpu_poll.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                  ctypes.c_int32, i32p, f32p, f32p, i32p]
        lib.vtpu_drain_new_keys.restype = ctypes.c_int32
        lib.vtpu_drain_new_keys.argtypes = [ctypes.c_void_p, u8p,
                                            ctypes.c_int32]
        lib.vtpu_drain_other.restype = ctypes.c_int32
        lib.vtpu_drain_other.argtypes = [ctypes.c_void_p, u8p,
                                         ctypes.c_int32]
        lib.vtpu_slot_scopes.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                         u8p, ctypes.c_int32]
        lib.vtpu_advance_interval.restype = ctypes.c_int32
        lib.vtpu_advance_interval.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int32]
        lib.vtpu_key_count.restype = ctypes.c_int64
        lib.vtpu_key_count.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.vtpu_intern.restype = ctypes.c_int32
        lib.vtpu_intern.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.c_int32, u8p, ctypes.c_int32,
                                    u8p, ctypes.c_int32]
        lib.vtpu_stats.argtypes = [ctypes.c_void_p, u64p]
        lib.vtpu_set_tags_exclude.argtypes = [ctypes.c_void_p, u8p,
                                              ctypes.c_int32]
        lib.vtpu_parse_one.restype = ctypes.c_int32
        lib.vtpu_parse_one.argtypes = [u8p, ctypes.c_int32, u8p,
                                       ctypes.c_int32, i32p]
        lib.vtpu_bench_parse.restype = ctypes.c_double
        lib.vtpu_bench_parse.argtypes = [u8p, ctypes.c_int32,
                                         ctypes.c_int32]
        lib.vtpu_bound_port.restype = ctypes.c_int32
        lib.vtpu_bound_port.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _bytes_arr(data: bytes) -> np.ndarray:
    """A writable u8 array holding `data` (one byte when it is empty, so
    the pointer is never null)."""
    return np.frombuffer(bytearray(data), np.uint8) if data else \
        np.zeros(1, np.uint8)


def parse_one(line: bytes):
    """Stateless conformance parse through the C++ parser.

    Returns (verdict, fields or None); the fields mirror
    parser.parse_metric's result: dict(name, type, joined_tags, digest,
    value, sample_rate, scope)."""
    lib = load()
    buf = np.zeros(4 + len(line) * 2 + 256, np.uint8)
    out_len = ctypes.c_int32(0)
    v = lib.vtpu_parse_one(_u8(_bytes_arr(line)), len(line), _u8(buf),
                           len(buf), ctypes.byref(out_len))
    if v != P_METRIC:
        return v, None
    b = buf.tobytes()[:out_len.value]
    mtype, scope = b[0], b[1]
    rate, value = struct.unpack_from("<dd", b, 2)
    (digest,) = struct.unpack_from("<I", b, 18)
    off = 22
    fields = []
    for _ in range(3):    # name, joined tags, set member
        (n,) = struct.unpack_from("<H", b, off)
        off += 2
        fields.append(b[off:off + n].decode())
        off += n
    name, tags, member = fields
    mname = _MTYPE_NAMES[mtype]
    return v, {
        "name": name, "type": mname, "joined_tags": tags,
        "digest": digest, "value": member if mname == "set" else value,
        "sample_rate": rate, "scope": scope,
    }


class NativeBridge:
    """Owning wrapper over one C++ bridge instance."""

    STATS = ("packets", "lines", "samples", "parse_errors", "slow_routed",
             "drops_no_slot", "ring_drops", "other_drops", "pending_other",
             "ssf_spans", "ssf_fallbacks", "ssf_errors", "ssf_other_drops",
             "pending_ssf_other")

    def __init__(self, histo_slots: int, counter_slots: int,
                 gauge_slots: int, set_slots: int, hll_precision: int = 14,
                 idle_ttl: int = 16, ring_capacity: int = 1 << 20,
                 max_packet: int = 8192):
        self._lib = load()
        self._h = self._lib.vtpu_create(
            histo_slots, counter_slots, gauge_slots, set_slots,
            hll_precision, idle_ttl, ring_capacity, max_packet)
        self.capacities = {"histo": histo_slots, "counter": counter_slots,
                           "gauge": gauge_slots, "set": set_slots}
        self.idle_ttl = idle_ttl
        self._key_buf = np.zeros(1 << 20, np.uint8)
        self._other_buf = np.zeros(1 << 20, np.uint8)
        self._closed = False

    def close(self):
        if not self._closed:
            self._closed = True
            self._lib.vtpu_destroy(self._h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -------- ingest --------

    def handle_packet(self, data: bytes):
        self._lib.vtpu_handle_packet(self._h, _u8(_bytes_arr(data)),
                                     len(data))

    def handle_ssf(self, data: bytes) -> int:
        """Decode one SSF span datagram and stage its samples natively
        (sinks/ssfmetrics.py's C++ twin). Returns 1 = handled, 0 = the
        caller must run the Python span path for this datagram (STATUS
        samples present; nothing was staged), -1 = malformed."""
        return int(self._lib.vtpu_handle_ssf(self._h, data, len(data)))

    def set_indicator_timer(self, name: str) -> None:
        """Enable the indicator-span duration timer
        (indicator_span_timer_name). Call before the readers start."""
        self._lib.vtpu_set_indicator_timer(self._h, name.encode())

    def set_tags_exclude(self, names) -> None:
        """Install tags_exclude (config.go sym: Config.TagsExclude) in the
        C++ parser. Call before start_udp: the reader threads read the
        list without a lock."""
        packed = "\n".join(names).encode()
        self._lib.vtpu_set_tags_exclude(self._h, _u8(_bytes_arr(packed)),
                                        len(packed))

    def start_udp(self, host: str, port: int, n_readers: int,
                  rcvbuf: int = 0) -> int:
        """Start `n_readers` C++ DogStatsD readers on one SO_REUSEPORT
        port (numeric host); returns the bound port."""
        rc = self._lib.vtpu_start_udp(
            self._h, host.encode(), port, n_readers, rcvbuf)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return rc

    def start_ssf_udp(self, host: str, port: int, n_readers: int,
                      rcvbuf: int = 0, max_dgram: int = 16384) -> int:
        """Start native SSF span readers (one datagram = one SSFSpan):
        recvmmsg, decode and ring staging in C++; fallback datagrams wait
        for drain_ssf_other. Returns the bound port."""
        rc = self._lib.vtpu_start_ssf_udp(
            self._h, host.encode(), port, n_readers, rcvbuf, max_dgram)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return rc

    def drain_ssf_other(self) -> list:
        """The fallback SSF datagrams (STATUS-carrying spans) for the
        Python span pipeline, as raw protobuf bytes."""
        out = []
        while True:
            n = self._lib.vtpu_drain_ssf_other(
                self._h, _u8(self._other_buf), len(self._other_buf))
            if n <= 0:
                break
            b = self._other_buf[:n].tobytes()
            off = 0
            while off < n:
                (ln,) = struct.unpack_from("<I", b, off)
                off += 4
                out.append(b[off:off + ln])
                off += ln
        return out

    def stop(self):
        self._lib.vtpu_stop(self._h)

    def bound_port(self) -> int:
        return self._lib.vtpu_bound_port(self._h)

    # -------- draining --------

    def poll(self, bank: str, out_slots, out_a, out_b, out_c) -> int:
        return self._lib.vtpu_poll(
            self._h, _BANKS[bank], len(out_slots), _i32(out_slots),
            _f32(out_a), _f32(out_b), _i32(out_c))

    def drain_new_keys(self):
        """The new-key records: (bank, mtype, scope, slot, name,
        joined_tags) tuples."""
        out = []
        while True:
            n = self._lib.vtpu_drain_new_keys(
                self._h, _u8(self._key_buf), len(self._key_buf))
            if n <= 0:
                break
            b = self._key_buf.tobytes()[:n]
            off = 0
            while off < n:
                bank, mtype, scope = b[off], b[off + 1], b[off + 2]
                (slot,) = struct.unpack_from("<i", b, off + 3)
                off += 7
                (nl,) = struct.unpack_from("<H", b, off)
                off += 2
                name = b[off:off + nl].decode()
                off += nl
                (tl,) = struct.unpack_from("<H", b, off)
                off += 2
                tags = b[off:off + tl].decode()
                off += tl
                out.append((bank, mtype, scope, slot, name, tags))
            if n < len(self._key_buf) // 2:
                break
        return out

    def drain_other(self):
        """The raw slow-path lines (bytes)."""
        out = []
        while True:
            n = self._lib.vtpu_drain_other(
                self._h, _u8(self._other_buf), len(self._other_buf))
            if n <= 0:
                break
            b = self._other_buf.tobytes()[:n]
            off = 0
            while off < n:
                (sl,) = struct.unpack_from("<H", b, off)
                off += 2
                out.append(b[off:off + sl])
                off += sl
            if n < len(self._other_buf) // 2:
                break
        return out

    def slot_scopes(self, bank: str) -> np.ndarray:
        out = np.zeros(self.capacities[bank], np.uint8)
        self._lib.vtpu_slot_scopes(self._h, _BANKS[bank], _u8(out),
                                   len(out))
        return out

    def advance_interval(self, bank: str) -> int:
        return self._lib.vtpu_advance_interval(self._h, _BANKS[bank])

    def key_count(self, bank: str) -> int:
        return self._lib.vtpu_key_count(self._h, _BANKS[bank])

    def intern(self, mtype: str, scope: int, name: str,
               joined_tags: str) -> int:
        """Intern one key through the C++ table (the slow path and the
        engine's Python entry points). Returns the slot, or -1 when the
        bank is full."""
        nb = name.encode()
        tb = joined_tags.encode()
        return self._lib.vtpu_intern(
            self._h, _MTYPE_NAMES.index(mtype), scope, _u8(_bytes_arr(nb)),
            len(nb), _u8(_bytes_arr(tb)), len(tb))

    def stats(self) -> dict:
        out = np.zeros(len(self.STATS), np.uint64)
        self._lib.vtpu_stats(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return dict(zip(self.STATS, out.tolist()))


class BridgeKeyView:
    """KeyInterner-shaped view of one bridge bank.

    The engine's flush reads active_items()/all_items()/scope_of()/
    key_of()/advance_interval()/len()/dropped_no_slot; here they are
    backed by the C++ interner plus a host mirror:
      * the slot-to-MetricKey mirror, updated from drain_new_keys();
      * the touched mask, marked by the pump from each polled batch under
        the engine lock (so it agrees with the bank the samples land in);
      * each slot's last touched interval, which retires a mirror entry
        when the C++ interner's idle eviction frees its slot (the same
        idle TTL, counted in the same advance_interval calls);
      * the scope snapshot, refreshed at flush time.
    """

    def __init__(self, bridge: NativeBridge, bank: str):
        self.bridge = bridge
        self.bank = bank
        self.capacity = bridge.capacities[bank]
        self.mirror: dict[int, MetricKey] = {}
        self.touched = np.zeros(self.capacity, bool)
        self._last = np.zeros(self.capacity, np.int64)
        self.interval = 0
        self._scopes = np.zeros(self.capacity, np.uint8)
        # per-slot SlotInfo holders carrying the engine's flush
        # presentation cache; replaced whenever the C++ interner gives a
        # slot to another key (register())
        self._holders: dict[int, SlotInfo] = {}
        self.dropped_no_slot = 0

    def __len__(self):
        return self.bridge.key_count(self.bank)

    def lookup(self, key: MetricKey, scope: int) -> int:
        """KeyInterner.lookup for the engine's Python entry points
        (engine.process on slow-path lines and dogfooded self-metrics):
        interns through the C++ table, mirrors the key and marks it
        touched. The caller holds the engine lock, so the mark and the
        landing are one step against the flush."""
        slot = self.bridge.intern(key.type, scope, key.name,
                                  key.joined_tags)
        if slot < 0:
            self.dropped_no_slot += 1
            return -1
        if self.mirror.get(slot) != key:
            self._holders[slot] = SlotInfo(slot, 0, scope)
        self.mirror[slot] = key
        self.touched[slot] = True
        self._last[slot] = self.interval
        return slot

    def register(self, slot: int, key: MetricKey):
        if self.mirror.get(slot) != key:
            self._holders[slot] = SlotInfo(slot, 0, 0)
        self.mirror[slot] = key
        self._last[slot] = self.interval

    def mark(self, slots: np.ndarray):
        self.touched[slots] = True
        self._last[slots] = self.interval

    def refresh_scopes(self):
        self._scopes = self.bridge.slot_scopes(self.bank)

    def key_of(self, slot: int):
        return self.mirror.get(slot)

    def scope_of(self, slot: int) -> int:
        return int(self._scopes[slot])

    def _items(self, slots):
        out = []
        scopes = self._scopes
        for slot in slots:
            key = self.mirror.get(slot)
            if key is not None:
                holder = self._holders.get(slot)
                if holder is None:
                    holder = self._holders[slot] = SlotInfo(slot, 0, 0)
                out.append((key, slot, int(scopes[slot]), holder))
        return out

    def active_items(self):
        """The keys touched this interval: (key, slot, scope, SlotInfo)."""
        self.refresh_scopes()
        return self._items(np.nonzero(self.touched)[0].tolist())

    def all_items(self):
        """Every key the C++ interner still holds, touched or idle (the
        rows a full forward export ships), in slot order."""
        self.refresh_scopes()
        return self._items(sorted(self.mirror))

    def advance_interval(self):
        self.touched[:] = False
        self.bridge.advance_interval(self.bank)
        self.interval += 1
        ttl = self.bridge.idle_ttl
        if ttl > 0 and self.interval >= ttl:
            # the C++ interner evicts a key idle past the TTL in this
            # same call; drop its mirror entry with it
            horizon = self.interval - ttl
            for slot in [s for s in self.mirror if self._last[s] < horizon]:
                del self.mirror[slot]
                self._holders.pop(slot, None)


class NativePump:
    """Polls the bridge and lands its batches in the engine.

    One pump thread replaces the per-line Python parse: it moves staged
    samples bank by bank (histo, counter, gauge, set: gauge sequence
    numbers follow this order) into the engine's ingest_*_batch methods
    in batches of at most `batch`, mirrors new key registrations, and
    hands slow-path lines to `slow_path` (the Python parser and the
    engine's process) and fallback span datagrams to `ssf_slow_path`.
    Each landing's host-to-device copies and kernel launches run in the
    pump thread under the engine lock; the engine must have run its
    probe (and so built the kernel library) before the pump starts.

    With `spans` (a flight recorder's SpanRing over PUMP_FIELDS) each
    cycle that moved samples is stamped there, and the pump keeps the
    counters the server drains each flush (`take_stats`): busy ns,
    engine-lock wait ns, cycles, and the highest bank fill.
    A bank's fill is what one drain of it moved before its ring came up
    empty: its backlog at that moment, against `ring_samples`, what the
    bank's rings hold for `writers` reader threads before they drop.
    """

    def __init__(self, bridge: NativeBridge, engine, views: dict,
                 slow_path, batch: int = 8192, idle_sleep: float = 0.002,
                 ssf_slow_path=None, ring_capacity: int = 1 << 20,
                 writers: int = 1, spans=None):
        self.bridge = bridge
        self.engine = engine
        self.views = views
        self.slow_path = slow_path
        self.ssf_slow_path = ssf_slow_path
        self.batch = batch
        self.idle_sleep = idle_sleep
        self.landed = 0     # samples landed in the engine, ever
        self.ring_samples = (ring_capacity // RING_WAYS + 1) \
            * max(1, min(writers, RING_WAYS))
        self.spans = spans
        # the stamped cycles' totals, ever (read by the flush)
        self.busy_ns = 0
        self.lock_wait_ns = 0
        self.cycles = 0
        self._peak_fill = 0
        self._taken = (0, 0, 0)
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # pump_once runs in the pump thread and in Server.drain(); they
        # share the poll buffers, so cycles are serialized
        self._pump_lock = threading.Lock()
        self._bufs = {
            b: (np.zeros(batch, np.int32), np.zeros(batch, np.float32),
                np.zeros(batch, np.float32), np.zeros(batch, np.int32))
            for b in _BANKS
        }

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="native-pump",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self):
        while not self._stop.is_set():
            try:
                moved = self.pump_once()
            except Exception:
                # a dead pump would halt all aggregation silently (the
                # rings fill and every sample drops): degrade loudly
                log.exception("pump cycle failed; retrying")
                time.sleep(0.1)
                continue
            if moved == 0:
                time.sleep(self.idle_sleep)

    def pump_once(self) -> int:
        """One poll cycle across all banks; returns the items moved."""
        with self._pump_lock:
            moved = self._pump_banks()
            for line in self.bridge.drain_other():
                self.slow_path(line)
                moved += 1
            if self.ssf_slow_path is not None:
                for payload in self.bridge.drain_ssf_other():
                    self.ssf_slow_path(payload)
                    moved += 1
            return moved

    def _pump_banks(self) -> int:
        """The banks' part of a cycle, in _BANKS' order, stamped into the
        span ring when there is one and the cycle moved samples."""
        spans, eng = self.spans, self.engine
        t0 = time.monotonic_ns()
        w0 = 0 if spans is None else eng.lock_wait_ns
        nh = self._pump_bank("histo")
        nc = self._pump_bank("counter")
        ng = self._pump_bank("gauge")
        ns = self._pump_bank("set")
        moved = nh + nc + ng + ns
        if moved and spans is not None:
            t1 = time.monotonic_ns()
            wait = eng.lock_wait_ns - w0
            spans.record(t0, t1, nh, nc, ng, ns, wait)
            self.busy_ns += t1 - t0
            self.lock_wait_ns += wait
            self.cycles += 1
            peak = max(nh, nc, ng, ns)
            if peak > self._peak_fill:
                with self._stats_lock:
                    self._peak_fill = max(self._peak_fill, peak)
        return moved

    def take_stats(self) -> tuple:
        """(busy ns, engine-lock wait ns, cycles) of the stamped cycles
        since the last call, and the highest bank fill since then
        (samples)."""
        with self._stats_lock:
            now = (self.busy_ns, self.lock_wait_ns, self.cycles)
            busy, wait, cycles = (a - b for a, b in zip(now, self._taken))
            self._taken = now
            peak, self._peak_fill = self._peak_fill, 0
        return busy, wait, cycles, peak

    def drain(self, timeout: float = 10.0) -> bool:
        """Pump until the bridge is empty; False when `timeout` seconds
        pass first."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            moved = self.pump_once()
            st = self.bridge.stats()
            if moved == 0 and st["pending_other"] == 0 \
                    and st["pending_ssf_other"] == 0:
                return True
        return False

    def _sync_keys(self):
        for bank_i, mtype, _scope, slot, name, tags in \
                self.bridge.drain_new_keys():
            bank = ("histo", "counter", "gauge", "set")[bank_i]
            self.views[bank].register(slot, MetricKey(
                name=name, type=_MTYPE_NAMES[mtype], joined_tags=tags))

    def _pump_bank(self, bank: str) -> int:
        slots, a, b, c = self._bufs[bank]
        total = 0
        eng = self.engine
        view = self.views[bank]
        while True:
            n = self.bridge.poll(bank, slots, a, b, c)
            if n <= 0:
                break
            # sync key records before the batch lands: the bridge queues a
            # key's record before its first sample reaches a ring, so
            # every slot of this batch resolves to its key in any flush
            # that follows the landing
            self._sync_keys()
            # COPY before landing: the engine must never hold the reused
            # poll buffers. On the CPU torch.as_tensor aliases a numpy
            # array, and the next poll would overwrite a batch the engine
            # still keeps (its staging, the set landing buffer's views)
            sl = slots[:n].copy()
            if bank == "histo":
                eng.ingest_histo_batch(sl, a[:n].copy(), b[:n].copy(),
                                       mark=view.mark)
            elif bank == "counter":
                eng.ingest_counter_batch(sl, a[:n].copy(), b[:n].copy(),
                                         mark=view.mark)
            elif bank == "gauge":
                eng.ingest_gauge_batch(sl, a[:n].copy(), mark=view.mark)
            else:
                # the set ring carries (slot, rho as f32, -, register)
                eng.ingest_set_batch(sl, c[:n].copy(),
                                     a[:n].astype(np.uint8),
                                     mark=view.mark)
            total += n
            self.landed += n
            if n < self.batch:
                break
        return total
