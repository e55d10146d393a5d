"""Kernel 4's (`soft_mask_cuda`) share of its roofline in the enhancement cell,
traced window."""

from harness import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "audio_s_per_s.bf16"
read = readers.roofline("soft_mask")
