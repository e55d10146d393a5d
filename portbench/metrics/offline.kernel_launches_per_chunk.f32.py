"""Device kernels launched a chunk inside the three kernel wrappers, in the float32 cells."""

from harness import program_trace

UNIT = "launches"
LAYER = "kernels"
MOVES = "audio_s_per_s.f32"
read = program_trace.kernel_launches_per_chunk
