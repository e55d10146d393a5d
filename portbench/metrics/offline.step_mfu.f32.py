"""The whole step's share of the card's peak in the float32 cells, traced window."""

from harness import readers

UNIT = "%"
LAYER = "device"
MOVES = "audio_s_per_s.f32"
read = readers.step_mfu
