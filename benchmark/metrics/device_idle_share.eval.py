"""Per-layer metric device_idle_share.eval: percent of the profiled pass in
which no operation ran on the card, from the pass traced with the
device's activity alone (no host op recorded)."""

from benchmark.metrics._read import idle_share


def read(ctx):
    return idle_share(ctx)
