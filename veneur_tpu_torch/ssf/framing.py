"""SSF stream framing: length-prefixed protobuf frames over TCP/UNIX (the
port's copy of veneur_tpu/ssf/framing.py).

Parity: protocol/wire.go (sym: protocol.ReadSSF, protocol.WriteSSF,
protocol.Message, protocol.ValidateTrace): one version byte, then a
little-endian uint32 payload length, then the SSFSpan protobuf.

Robustness contract (mirrors the reference's): a frame that is
oversized, truncated, or fails protobuf decoding raises a framing error
the caller can distinguish from connection EOF, so one bad client cannot
wedge a listener.
"""

from __future__ import annotations

import struct

VERSION_BYTE = 0x00
_LEN = struct.Struct("<I")

# Defensive bound mirroring the reference's refusal to allocate
# attacker-controlled buffer sizes.
MAX_FRAME_LENGTH = 16 * 1024 * 1024


class FramingError(ValueError):
    """Bad frame (version, length, or protobuf decode)."""


def write_ssf(span) -> bytes:
    """Encode one span as a stream frame (protocol.WriteSSF)."""
    payload = span.SerializeToString()
    return bytes([VERSION_BYTE]) + _LEN.pack(len(payload)) + payload


def _read_exact(read, n: int) -> bytes:
    """Read exactly n bytes from `read` (a socket-style or file-style
    callable is normalised by read_ssf); b'' mid-message = truncation."""
    chunks = []
    got = 0
    while got < n:
        c = read(n - got)
        if not c:
            raise EOFError(f"stream closed mid-frame ({got}/{n} bytes)")
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def read_ssf_frame(stream) -> bytes | None:
    """Read one frame's raw protobuf payload. Returns None on clean EOF;
    raises FramingError on a corrupt frame and EOFError on truncation
    mid-frame."""
    read = stream.recv if hasattr(stream, "recv") else stream.read
    first = read(1)
    if not first:
        return None
    if first[0] != VERSION_BYTE:
        raise FramingError(f"unknown SSF frame version {first[0]:#x}")
    (length,) = _LEN.unpack(_read_exact(read, 4))
    if length > MAX_FRAME_LENGTH:
        raise FramingError(f"frame length {length} exceeds max "
                           f"{MAX_FRAME_LENGTH}")
    return _read_exact(read, length)


def read_ssf(stream):
    """Read one framed span (protocol.ReadSSF). Returns None on clean
    EOF (closed between frames); raises FramingError on a corrupt frame
    and EOFError on truncation mid-frame."""
    payload = read_ssf_frame(stream)
    if payload is None:
        return None
    from .protos import ssf_pb2
    try:
        return ssf_pb2.SSFSpan.FromString(payload)
    except Exception as e:
        raise FramingError(f"bad SSF protobuf payload: {e}") from e


def parse_ssf_datagram(data: bytes):
    """UDP SSF: the datagram is a bare SSFSpan protobuf, no framing
    (Server.ReadSSFPacketSocket)."""
    from .protos import ssf_pb2
    try:
        return ssf_pb2.SSFSpan.FromString(data)
    except Exception as e:
        raise FramingError(f"bad SSF datagram: {e}") from e


def validate_trace(span) -> bool:
    """Is this span a *trace* span (id + start/end present), as opposed
    to a bare metrics carrier (protocol.ValidateTrace)?"""
    return bool(span.id and span.start_timestamp and span.end_timestamp
                and span.name)
