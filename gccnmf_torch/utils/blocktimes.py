from gccnmf_torch.native import BlockTimes  # noqa: F401  (the native tier's block-time ring)
