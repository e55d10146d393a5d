"""Share of the traced window with the card idle in the enhancement cell."""

from harness import readers

UNIT = "%"
LAYER = "device"
MOVES = "audio_s_per_s.bf16"
read = readers.idle_pct("offline")
