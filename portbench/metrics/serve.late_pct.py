"""Share of the window's ticks whose outputs reached the host more than
one block interval (the deadline) after the tick fell due."""

UNIT = "%"
LAYER = "entry points"
MOVES = "tick_p95_ms"


def read(rec):
    serve = rec.get("serve")
    if not serve or not serve["latency_s"]:
        return None
    late = sum(1 for v in serve["latency_s"] if v > serve["deadline_s"])
    return 100.0 * late / len(serve["latency_s"])
