"""Time a chunk of `gccnmf.enhance.compute`, the host's enqueue, in the
enhancement cell."""

from harness import program_trace

UNIT = "ms"
LAYER = "host stages"
MOVES = "audio_s_per_s.bf16"
read = program_trace.span_ms_per_chunk("gccnmf.enhance.compute", "s")
