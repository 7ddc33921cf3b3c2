"""The load generator's 99th-percentile lateness: submit time minus due
time over the window's requests (host clock)."""


def read(ctx):
    return ctx.counters.get("lag_p99_ms")
