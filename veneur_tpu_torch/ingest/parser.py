"""DogStatsD wire-format parser (the port's copy of veneur_tpu.ingest.parser,
kept verbatim so that the port imports nothing of the JAX package).

Parity target: samplers/parser.go (sym: ParseMetric, ParseEvent,
ParseServiceCheck; types UDPMetric, MetricKey; scope consts MixedScope /
LocalOnly / GlobalOnly). The grammar:

  metric:        <name>:<value>|<type>[|@<rate>][|#<tag1:v1,tag2>]
  event:         _e{<title_len>,<text_len>}:<title>|<text>[|d:ts|h:host|
                 k:aggkey|p:prio|s:source|t:alerttype|#tags]
  service check: _sc|<name>|<status>[|d:ts|h:host|#tags|m:message]

Types: c (counter), g (gauge), ms (timer), h (histogram), s (set),
d (distribution — treated as histogram with global scope, matching how
veneur maps DogStatsD distributions onto its global aggregation).

Veneur extensions honored here exactly like the reference:
  * a `veneurlocalonly` tag forces LocalOnly scope, `veneurglobalonly`
    forces GlobalOnly; both are *stripped* from the stored tag set.
  * tags are sorted and joined with "," into MetricKey.JoinedTags.
  * the 32-bit FNV-1a digest over name+type+joined tags shards the key
    space (server.go: `Workers[Digest % len(Workers)]`).

This pure-Python parser is the conformance reference for both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..utils.hashing import metric_digest

MIXED_SCOPE = 0
LOCAL_ONLY = 1
GLOBAL_ONLY = 2

_TYPE_MAP = {
    b"c": "counter",
    b"g": "gauge",
    b"ms": "timer",
    b"h": "histogram",
    b"s": "set",
    b"d": "histogram",  # DogStatsD distribution -> globally-merged histogram
}


class ParseError(ValueError):
    pass


# Hardening defaults (config keys metric_max_name_length /
# metric_max_tag_length): a metric name or single tag past these is a
# COUNTED parse error, never an interned key — an adversarial packet
# minting multi-KB names must not grow the bank or the interner map
# (the overload-defense stance: degradation is counted, not silent,
# and never unbounded). Callers with a Config pass its values through.
MAX_NAME_LENGTH = 1024
MAX_TAG_LENGTH = 512


@dataclass(frozen=True)
class MetricKey:
    name: str
    type: str
    joined_tags: str


@dataclass
class UDPMetric:
    """One parsed sample (samplers.UDPMetric equivalent)."""
    key: MetricKey
    digest: int
    value: float | str     # str for sets
    sample_rate: float = 1.0
    scope: int = MIXED_SCOPE
    tags: list[str] = field(default_factory=list)


@dataclass
class Event:
    title: str
    text: str
    timestamp: Optional[int] = None
    hostname: str = ""
    aggregation_key: str = ""
    priority: str = ""
    source_type: str = ""
    alert_type: str = ""
    tags: list[str] = field(default_factory=list)


@dataclass
class ServiceCheck:
    name: str
    status: int
    timestamp: Optional[int] = None
    hostname: str = ""
    message: str = ""
    tags: list[str] = field(default_factory=list)


def parse_metric(packet: bytes,
                 exclude_tags: frozenset | None = None,
                 max_name_len: int = MAX_NAME_LENGTH,
                 max_tag_len: int = MAX_TAG_LENGTH) -> UDPMetric:
    """Parse one DogStatsD metric line (no trailing newline).

    `exclude_tags` (config.go sym: Config.TagsExclude) drops tags whose
    NAME (the part before ":", or the whole tag) matches — before key
    construction, so metrics differing only in an excluded tag aggregate
    together, exactly like the reference. `max_name_len`/`max_tag_len`
    reject oversized names/tags as parse errors BEFORE any key exists
    (parser hardening — see MAX_NAME_LENGTH above)."""
    if not packet:
        raise ParseError("empty packet")

    colon = packet.find(b":")
    if colon <= 0:
        raise ParseError(f"missing name/value separator: {packet!r}")
    if colon > max_name_len:
        raise ParseError(
            f"metric name over {max_name_len} bytes "
            f"(got {colon}): {packet[:64]!r}...")
    name = packet[:colon]
    rest = packet[colon + 1:]

    parts = rest.split(b"|")
    if len(parts) < 2:
        raise ParseError(f"missing type: {packet!r}")
    valstr, typestr = parts[0], parts[1]

    mtype = _TYPE_MAP.get(typestr)
    if mtype is None:
        raise ParseError(f"invalid type {typestr!r} in {packet!r}")

    if mtype == "set":
        value: float | str = valstr.decode("utf-8", "replace")
    else:
        if not valstr:
            raise ParseError(f"empty value: {packet!r}")
        try:
            value = float(valstr)
        except ValueError:
            raise ParseError(f"invalid value {valstr!r} in {packet!r}")
        if value != value or value in (float("inf"), float("-inf")):
            raise ParseError(f"non-finite value in {packet!r}")

    sample_rate = 1.0
    tags: list[str] = []
    scope = GLOBAL_ONLY if typestr == b"d" else MIXED_SCOPE
    seen_rate = False
    seen_tags = False

    for section in parts[2:]:
        if not section:
            raise ParseError(f"empty section in {packet!r}")
        lead = section[:1]
        if lead == b"@":
            if seen_rate:
                raise ParseError(f"duplicate sample rate in {packet!r}")
            seen_rate = True
            try:
                sample_rate = float(section[1:])
            except ValueError:
                raise ParseError(f"invalid sample rate in {packet!r}")
            if not (0.0 < sample_rate <= 1.0):
                raise ParseError(f"sample rate out of range in {packet!r}")
            if mtype in ("gauge", "set") and sample_rate != 1.0:
                # matches the reference: rates only make sense for
                # counters/timers/histograms
                raise ParseError(
                    f"sample rate invalid for {mtype}: {packet!r}")
        elif lead == b"#":
            if seen_tags:
                raise ParseError(f"duplicate tag section in {packet!r}")
            seen_tags = True
            for t in section[1:].split(b","):
                if len(t) > max_tag_len:
                    raise ParseError(
                        f"tag over {max_tag_len} bytes "
                        f"(got {len(t)}): {t[:64]!r}...")
                ts = t.decode("utf-8", "replace")
                if ts == "veneurlocalonly":
                    scope = LOCAL_ONLY
                elif ts == "veneurglobalonly":
                    scope = GLOBAL_ONLY
                elif ts:
                    tags.append(ts)
            if exclude_tags:
                tags = [t for t in tags
                        if t.partition(":")[0] not in exclude_tags]
            tags.sort()
        else:
            raise ParseError(f"unknown section {section!r} in {packet!r}")

    if not name:
        raise ParseError(f"empty metric name: {packet!r}")
    name_s = name.decode("utf-8", "replace")
    joined = ",".join(tags)
    key = MetricKey(name=name_s, type=mtype, joined_tags=joined)
    return UDPMetric(
        key=key,
        digest=metric_digest(name_s, mtype, joined),
        value=value,
        sample_rate=sample_rate,
        scope=scope,
        tags=tags,
    )


def parse_event(packet: bytes) -> Event:
    """Parse a DogStatsD event: _e{tl,xl}:title|text|..."""
    if not packet.startswith(b"_e{"):
        raise ParseError(f"not an event: {packet!r}")
    close = packet.find(b"}")
    if close < 0:
        raise ParseError(f"unterminated length header: {packet!r}")
    lens = packet[3:close].split(b",")
    if len(lens) != 2:
        raise ParseError(f"bad length header: {packet!r}")
    try:
        tl, xl = int(lens[0]), int(lens[1])
    except ValueError:
        raise ParseError(f"bad length header: {packet!r}")
    if tl < 0 or xl < 0:
        raise ParseError(f"negative length in header: {packet!r}")
    if packet[close + 1: close + 2] != b":":
        raise ParseError(f"missing ':' after header: {packet!r}")
    body = packet[close + 2:]
    if len(body) < tl + 1 + xl:
        raise ParseError(f"truncated event body: {packet!r}")
    title = body[:tl]
    if body[tl: tl + 1] != b"|":
        raise ParseError(f"bad title length: {packet!r}")
    text = body[tl + 1: tl + 1 + xl]
    ev = Event(title=title.decode("utf-8", "replace"),
               text=text.decode("utf-8", "replace").replace("\\n", "\n"))
    for section in body[tl + 1 + xl:].split(b"|"):
        if not section:
            continue
        if section.startswith(b"d:"):
            try:
                ev.timestamp = int(section[2:])
            except ValueError:
                raise ParseError(f"bad event timestamp: {packet!r}")
        elif section.startswith(b"h:"):
            ev.hostname = section[2:].decode("utf-8", "replace")
        elif section.startswith(b"k:"):
            ev.aggregation_key = section[2:].decode("utf-8", "replace")
        elif section.startswith(b"p:"):
            ev.priority = section[2:].decode("utf-8", "replace")
        elif section.startswith(b"s:"):
            ev.source_type = section[2:].decode("utf-8", "replace")
        elif section.startswith(b"t:"):
            ev.alert_type = section[2:].decode("utf-8", "replace")
        elif section.startswith(b"#"):
            ev.tags = sorted(
                t.decode("utf-8", "replace")
                for t in section[1:].split(b",") if t)
        else:
            raise ParseError(f"unknown event section {section!r}")
    return ev


def parse_service_check(packet: bytes) -> ServiceCheck:
    """Parse a DogStatsD service check: _sc|name|status|..."""
    if not packet.startswith(b"_sc|"):
        raise ParseError(f"not a service check: {packet!r}")
    parts = packet.split(b"|")
    if len(parts) < 3:
        raise ParseError(f"truncated service check: {packet!r}")
    name = parts[1].decode("utf-8", "replace")
    try:
        status = int(parts[2])
    except ValueError:
        raise ParseError(f"bad status: {packet!r}")
    if status not in (0, 1, 2, 3):
        raise ParseError(f"status out of range: {packet!r}")
    sc = ServiceCheck(name=name, status=status)
    for section in parts[3:]:
        if section.startswith(b"d:"):
            try:
                sc.timestamp = int(section[2:])
            except ValueError:
                raise ParseError(f"bad timestamp: {packet!r}")
        elif section.startswith(b"h:"):
            sc.hostname = section[2:].decode("utf-8", "replace")
        elif section.startswith(b"m:"):
            sc.message = section[2:].decode("utf-8", "replace")
        elif section.startswith(b"#"):
            sc.tags = sorted(
                t.decode("utf-8", "replace")
                for t in section[1:].split(b",") if t)
        else:
            raise ParseError(f"unknown sc section {section!r}")
    return sc


def parse_packet(packet: bytes, exclude_tags: frozenset | None = None,
                 max_name_len: int = MAX_NAME_LENGTH,
                 max_tag_len: int = MAX_TAG_LENGTH):
    """Dispatch one datagram line to the right parser, like
    Server.HandleMetricPacket (server.go)."""
    if packet.startswith(b"_e{"):
        return parse_event(packet)
    if packet.startswith(b"_sc|"):
        return parse_service_check(packet)
    return parse_metric(packet, exclude_tags, max_name_len, max_tag_len)
