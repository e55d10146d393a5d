"""Device busy milliseconds a tick (kernels and copies, their union),
traced ticks."""

UNIT = "ms"
LAYER = "captured step"
MOVES = "tick_p95_ms"


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("steps") or "serve" not in rec:
        return None
    return 1e3 * tr["busy_s"] / tr["steps"]
