"""TL01 good fixture: self-metrics counted through the telemetry
registry, which mints the veneur.* names. This docstring names
veneur.packet.received_total freely."""


def count_packets(registry, n):
    registry.incr("_server", "packet.received", n)


def unrelated_name():
    return "veneurish.prefix_that_does_not_match"
