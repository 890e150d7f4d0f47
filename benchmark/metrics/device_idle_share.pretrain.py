"""Per-layer metric device_idle_share.pretrain: percent of the profiled
steps in which no operation ran on the card, from the steps traced with
the device's activity alone (no host op recorded)."""

from benchmark.metrics._read import idle_share


def read(ctx):
    return idle_share(ctx)
