"""99th percentile over the window's ticks of the time from due time to
the outputs on the host (host clock): the tail nearest the deadline."""

from harness.common import quantile

UNIT = "ms"
LAYER = "entry points"
MOVES = "tick_p95_ms"


def read(rec):
    serve = rec.get("serve")
    if not serve or not serve["latency_s"]:
        return None
    return 1e3 * quantile(serve["latency_s"], 0.99)
