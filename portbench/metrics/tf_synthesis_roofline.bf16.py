"""Kernel 5's (`tf_synthesis_cuda`) share of its roofline in the enhancement
cell, traced window."""

from harness import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "audio_s_per_s.bf16"
read = readers.roofline("tf_synthesis")
