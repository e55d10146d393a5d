"""Device kernels launched a chunk inside the three kernel wrappers, in the bf16 cells."""

from harness import program_trace

UNIT = "launches"
LAYER = "kernels"
MOVES = "audio_s_per_s.bf16"
read = program_trace.kernel_launches_per_chunk
