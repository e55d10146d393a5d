"""Audio seconds separated a second in the bf16 cells: the audio of the chunks
completed in the window over the window's wall time (host clock)."""

from harness import readers

UNIT = "audio-s/s"
LAYER = "end_to_end"
MOVES = None
read = readers.audio_s_per_s
