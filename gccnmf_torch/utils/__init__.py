"""Host-side utilities: WAV I/O."""
