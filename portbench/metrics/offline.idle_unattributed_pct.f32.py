"""Share of the traced window with the card idle and no program span open, in the float32 cells."""

from harness import program_trace

UNIT = "%"
LAYER = "host stages"
MOVES = "audio_s_per_s.f32"
read = program_trace.idle_unattributed_pct
