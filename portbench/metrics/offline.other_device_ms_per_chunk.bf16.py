"""Device ms a chunk launched outside the three kernel wrappers in the bf16 cells."""

from harness import readers

UNIT = "ms"
LAYER = "torch ops"
MOVES = "audio_s_per_s.bf16"
read = readers.other_device_ms_per_chunk
