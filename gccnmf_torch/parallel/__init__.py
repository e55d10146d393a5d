"""Long-audio separation (counterpart of ``gccnmf_tpu/parallel/``): the
one-device paths of ``long_audio.LongAudioSeparator``."""
