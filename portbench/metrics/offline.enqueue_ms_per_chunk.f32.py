"""Time a chunk of `gccnmf.offline.compute`, the host's enqueue, in the float32 cells."""

from harness import program_trace

UNIT = "ms"
LAYER = "host stages"
MOVES = "audio_s_per_s.f32"
read = program_trace.span_ms_per_chunk("gccnmf.offline.compute", "s")
