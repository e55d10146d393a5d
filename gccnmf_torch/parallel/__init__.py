"""Long audio and process groups (counterpart of ``gccnmf_tpu/parallel/``):
``mesh`` (process groups and the (data, model) mesh), ``launch`` (worlds of
ranks), ``nmf_sharded``, ``trainer`` and ``long_audio``."""
