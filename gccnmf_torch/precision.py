"""Float32 means true fp32: the port's counterpart of ``ops/xprec.py``.

The JAX package asks XLA for ``Precision.HIGHEST`` on its parity GEMMs. On
the card, PyTorch runs float32 matrix products in full fp32 by default, but
cuDNN convolutions default to TF32 (about three decimal digits). The
separator switches both off when it is built, so every float32 product on
the plain path is exact fp32.
"""

from __future__ import annotations

import torch

__all__ = ["set_fp32_precision", "round_bf16", "bf16_operands"]


def set_fp32_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN (process-wide torch flags)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to the nearest bf16 (even on ties), kept fp32: a
    GEMM operand in the bf16 modes."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_operands(matmul_dtype: str) -> bool:
    """Whether a kernel's GEMM operands round to bf16: ``"float32"`` → no,
    ``"bfloat16"`` → yes; any other mode raises."""
    if matmul_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"matmul_dtype must be float32 or bfloat16, got {matmul_dtype!r}")
    return matmul_dtype == "bfloat16"
