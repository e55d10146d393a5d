"""Seconds from the start of the run to the end of the warm-up: import,
kernel library load (a build in a fresh checkout), inputs, warm-up."""

UNIT = "s"
LAYER = "end_to_end"
MOVES = None


def read(rec):
    return rec.get("setup_s")
