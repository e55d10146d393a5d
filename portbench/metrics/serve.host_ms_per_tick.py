"""Mean wall milliseconds inside ``process()`` over the window's ticks,
less the device busy milliseconds a tick of the traced ticks."""

UNIT = "ms"
LAYER = "entry points"
MOVES = "tick_p95_ms"


def read(rec):
    tr, serve = rec.get("trace"), rec.get("serve")
    if not tr or not serve or not tr.get("steps") or not serve["process_s"]:
        return None
    mean_ms = 1e3 * sum(serve["process_s"]) / len(serve["process_s"])
    return mean_ms - 1e3 * tr["busy_s"] / tr["steps"]
