"""Kernel 3's (`stft_gcc_frontend_cuda`) share of its roofline in the bf16 cells,
traced window."""

from harness import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "audio_s_per_s.bf16"
read = readers.roofline("frontend")
