"""Self time a chunk of `gccnmf.offline.materialize` (no wait, no trim), in the bf16 cells."""

from harness import program_trace

UNIT = "ms"
LAYER = "host stages"
MOVES = "audio_s_per_s.bf16"
read = program_trace.span_ms_per_chunk("gccnmf.offline.materialize", "self_s")
