"""95th percentile over every tick of the window of the time from the
tick's due time to the return of ``process()`` (host clock)."""

from harness.common import quantile

UNIT = "ms"
LAYER = "end_to_end"
MOVES = None


def read(rec):
    serve = rec.get("serve")
    if not serve or not serve["latency_s"]:
        return None
    return 1e3 * quantile(serve["latency_s"], 0.95)
