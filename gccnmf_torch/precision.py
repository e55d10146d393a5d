"""Float32 means true fp32: the port's counterpart of ``ops/xprec.py``.

The JAX package asks XLA for ``Precision.HIGHEST`` on its parity GEMMs. On
the card, PyTorch runs float32 matrix products in full fp32 by default, but
cuDNN convolutions default to TF32 (about three decimal digits). The
separator switches both off when it is built, so every float32 product on
the plain path is exact fp32.
"""

from __future__ import annotations

import torch

__all__ = ["set_fp32_precision", "round_bf16"]


def set_fp32_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN (process-wide torch flags)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to the nearest bf16 (even on ties), kept fp32: a
    GEMM operand in the bf16 modes."""
    return x.to(torch.bfloat16).to(torch.float32)

