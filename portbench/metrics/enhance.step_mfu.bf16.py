"""The whole enhancement step's share of the card's peak: kernels 3-5's least
time over the traced window's wall time."""

from harness import readers

UNIT = "%"
LAYER = "device"
MOVES = "audio_s_per_s.bf16"
read = readers.step_mfu
