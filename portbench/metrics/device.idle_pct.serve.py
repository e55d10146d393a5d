"""Share of the traced window of paced ticks in which no kernel or copy
ran on the card (the mean over the cards used)."""

from harness import readers

UNIT = "%"
LAYER = "device"
MOVES = "tick_p95_ms"
read = readers.idle_pct("serve")
