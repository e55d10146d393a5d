"""DSP ops on tensors and the CUDA kernels' wrappers: windows, STFT/ISTFT,
GCC-PHAT, KL-NMF, localization, masking."""
