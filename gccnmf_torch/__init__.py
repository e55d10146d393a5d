"""gccnmf_torch — GCC-NMF on PyTorch and CUDA for NVIDIA Hopper.

The PyTorch counterpart of :mod:`gccnmf_tpu`, with the same module layout
(``ops/stft.py`` here mirrors ``gccnmf_tpu/ops/stft.py`` there, and so on).
Plain tensor code is PyTorch; every kernel that the JAX package wrote in
Pallas for the TPU is a CUDA C++ kernel under ``csrc/``, built with ``nvcc``
at first use (``_build.py``) and bound with ``ctypes``. Each kernel keeps a
plain PyTorch version beside it, which is what runs on CPU tensors.

Importing the package needs neither CUDA nor a compiler: kernels build
lazily. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from gccnmf_torch.defs import SPEED_OF_SOUND_M_S
from gccnmf_torch.models.offline import GCCNMFEnhancer
from gccnmf_torch.models.online import OnlineGCCNMFEnhancer

__all__ = ["GCCNMFEnhancer", "OnlineGCCNMFEnhancer", "SPEED_OF_SOUND_M_S", "__version__"]
