"""Kernel 1's (`kl_nmf_cuda`) share of its roofline in the float32 cells, traced window."""

from harness import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "audio_s_per_s.f32"
read = readers.roofline("nmf")
