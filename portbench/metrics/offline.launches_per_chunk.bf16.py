"""Device kernels launched a chunk in the bf16 cells, from the trace."""

from harness import readers

UNIT = "launches"
LAYER = "host stages"
MOVES = "audio_s_per_s.bf16"
read = readers.launches_per_chunk
