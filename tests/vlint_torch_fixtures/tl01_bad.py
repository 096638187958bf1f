"""TL01 fixture: ad-hoc veneur.* self-metric emission outside the
unified telemetry registry. This docstring names veneur.example_total
and must stay silent (documentation is exempt)."""


class InterMetric:
    def __init__(self, name, value):
        self.name = name
        self.value = value


def adhoc_metric(count):
    return InterMetric("veneur.packet.received_total", count)  # TL01


def adhoc_fstring(dest, n):
    return InterMetric(f"veneur.resilience.{dest}_total", n)   # TL01


def raw_dict_counter(stats):
    stats["veneur.worker.dropped_total"] = (                   # TL01
        stats.get("veneur.worker.dropped_total", 0) + 1)       # TL01


def documented_emitter(count):
    # vlint: disable=TL01 reason=fixture-only legacy exporter kept for
    # wire parity; the registry drains the real counter
    return InterMetric("veneur.legacy.export_total", count)


def unrelated_name():
    return "veneurish.prefix_that_does_not_match"
