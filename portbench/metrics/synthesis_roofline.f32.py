"""Kernel 2's (`masked_synthesis_cuda`) share of its roofline in the float32 cells,
traced window."""

from harness import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "audio_s_per_s.f32"
read = readers.roofline("synthesis")
