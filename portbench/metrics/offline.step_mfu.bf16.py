"""The whole step's share of the card's peak in the bf16 cells, traced window."""

from harness import readers

UNIT = "%"
LAYER = "device"
MOVES = "audio_s_per_s.bf16"
read = readers.step_mfu
