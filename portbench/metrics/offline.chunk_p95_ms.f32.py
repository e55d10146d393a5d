"""p95 of the wall time between chunks yielded in the float32 cells (host clock)."""

from harness import readers

UNIT = "ms"
LAYER = "entry points"
MOVES = "audio_s_per_s.f32"
read = readers.chunk_p95_ms
