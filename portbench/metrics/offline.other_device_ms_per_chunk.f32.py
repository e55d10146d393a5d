"""Device ms a chunk launched outside the three kernel wrappers in the float32 cells."""

from harness import readers

UNIT = "ms"
LAYER = "torch ops"
MOVES = "audio_s_per_s.f32"
read = readers.other_device_ms_per_chunk
