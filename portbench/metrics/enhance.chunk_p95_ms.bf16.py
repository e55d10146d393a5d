"""p95 of the wall time between chunks yielded in the enhancement cell (host
clock)."""

from harness import readers

UNIT = "ms"
LAYER = "entry points"
MOVES = "audio_s_per_s.bf16"
read = readers.chunk_p95_ms
