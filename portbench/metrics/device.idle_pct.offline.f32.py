"""Share of the traced window with the card idle in the float32 cells."""

from harness import readers

UNIT = "%"
LAYER = "device"
MOVES = "audio_s_per_s.f32"
read = readers.idle_pct("offline")
