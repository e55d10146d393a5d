"""KL-divergence NMF with multiplicative updates on tensors (counterpart of
``gccnmf_tpu/ops/nmf.py``).

Layout: ``V`` and ``H`` are time-major (``V: (T, F)``, ``H: (T, K)``); the
dictionary is ``W: (F, K)``. Update rules follow the reference exactly
(gccNMF/gccNMFFunctions.py:69-83):

    H ← H ⊙ (Wᵀ(V/WH)) / (Σ_f W + α + ε)
    W ← W ⊙ ((V/WH) Hᵀ) / (Σ_t H)
    W ← W / ||W||₂(per atom);  H ← H ⊙ ||W||₂

The turbo mode (``"bfloat16_q_simul"``, :func:`kl_nmf_simul` in fp32) runs
simultaneous updates instead: one Q = V/WH per iteration feeds both, the W
update reads the pre-update H, and a closed-form gain on H restores
Σ(WH) = Σ(V) after the renormalisation.

The fused CUDA kernel and its plain twin live in ``ops/nmf_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from gccnmf_torch.precision import round_bf16

__all__ = [
    "nmf_init_numpy", "kl_nmf", "kl_nmf_minibatch_w", "kl_nmf_simul", "h_infer", "kl_divergence", "safe_div",
    "order_atoms_by_centroid", "MATMUL_DTYPES",
]

_TINY = 1e-30

# Operand rounding of the products; the fused kernel's modes (ops/nmf_cuda.py)
MATMUL_DTYPES = ("float32", "bfloat16", "bfloat16_q", "bfloat16_q_simul")


def nmf_init_numpy(
    num_freq: int,
    dictionary_size: int,
    num_time: int,
    epsilon: float = 1e-16,
    seed_value: int = 0,
):
    """Reference-identical seeded init (gccNMFFunctions.py:70-73).

    Same MT19937 stream as the reference's global ``seed(0)`` draws — W
    first, H second, both cast to float32 before adding epsilon — drawn from
    a private RandomState so the caller's global ``np.random`` state is left
    alone. Returns NumPy ``(W0 (F, K), H0 (T, K))``, H time-major.
    """
    rs = np.random.RandomState(seed_value)
    w0 = rs.random_sample((num_freq, dictionary_size)).astype(np.float32) + epsilon
    h0 = rs.random_sample((dictionary_size, num_time)).astype(np.float32) + epsilon
    return w0, np.ascontiguousarray(h0.T)


def safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The double-``where`` divide: 0 where ``b <= 1e-30``, ``a / b``
    elsewhere (a clamp is not the same: it turns 0/0 into 0/tiny)."""
    ok = b > _TINY
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def kl_nmf(
    v: torch.Tensor,
    w0: torch.Tensor,
    h0: torch.Tensor,
    num_iterations: int,
    sparsity_alpha: float = 0.0,
    epsilon: float = 1e-16,
    guard: bool = False,
    matmul_dtype: str = "float32",
):
    """Run ``num_iterations`` multiplicative KL updates, accumulating in fp32.

    ``v``: (..., T, F) nonneg; ``w0``: (..., F, K); ``h0``: (..., T, K).
    Returns ``(W, H)`` float32. ``guard=False`` is the reference-exact divide
    discipline (0/0 → NaN on digital silence); ``guard=True`` takes the
    double-``where`` divides, identical wherever the unguarded result is
    finite.

    ``matmul_dtype`` rounds the products' operands as the fused kernel's
    modes do: ``"float32"`` not at all; ``"bfloat16"`` every GEMM operand to
    bf16; ``"bfloat16_q"`` also forms Q = bf16(bf16(V) · bf16(1/WH)), 0
    where WH <= 1e-30 whatever ``guard`` says (nmf_pallas.py:147-160).
    ``"bfloat16_q_simul"`` rounds as ``"bfloat16_q"`` and runs the turbo
    updates of :func:`kl_nmf_simul` (nmf_pallas.py:175-204), always
    guarded.
    """
    if matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(f"unknown matmul_dtype {matmul_dtype!r}: want {list(MATMUL_DTYPES)}")
    simul = matmul_dtype == "bfloat16_q_simul"
    return _updates(v, w0, h0, num_iterations, sparsity_alpha, epsilon,
                    safe_div if guard or simul else torch.div, matmul_dtype, simul)


def kl_nmf_minibatch_w(
    v: torch.Tensor,
    w0: torch.Tensor,
    h0: torch.Tensor,
    num_iterations: int,
    sparsity_alpha: float = 0.0,
    epsilon: float = 1e-16,
):
    """Batched KL-NMF with one shared dictionary: ``v`` (..., T, F) and
    ``h0`` (..., T, K) carry leading batch dims, ``w0`` is (F, K), and the W
    statistics are summed over the batch and over time (the in-graph
    counterpart of the sharded NMF's all-reduce). Unguarded fp32 divides, as
    JAX's; returns ``(W (F, K), H)``."""
    v = v.to(torch.float32)
    w, h = w0.to(torch.float32), h0.to(torch.float32)
    lead = tuple(range(h.dim() - 1))  # every axis of H but the atoms'
    for _ in range(num_iterations):
        h = h * ((v / (h @ w.T)) @ w) / (w.sum(dim=0) + sparsity_alpha + epsilon)
        q = v / (h @ w.T)
        num = torch.einsum("...tf,...tk->fk", q, h)
        w = w * num / h.sum(dim=lead)
        norms = torch.sqrt((w * w).sum(dim=0))
        w, h = w / norms, h * norms
    return w, h


def kl_nmf_simul(
    v: torch.Tensor,
    w0: torch.Tensor,
    h0: torch.Tensor,
    num_iterations: int,
    sparsity_alpha: float = 0.0,
    epsilon: float = 1e-16,
):
    """The turbo updates in fp32 (counterpart of ``nmf.kl_nmf_simul``, the
    XLA twin of the Pallas ``"bfloat16_q_simul"`` mode). Per iteration one
    guarded Q = V/(H·Wᵀ) feeds both updates:

        H' ← H ⊙ (Q·W) / (Σ_f W + α + ε)
        W  ← W ⊙ div(Qᵀ·H, Σ_t H)             (the pre-update H)
        W ← W / ||W||₂;  H' ← H' ⊙ ||W||₂      (per atom)
        H' ← H' · ΣV / Σ_k(Σ_f W)(Σ_t H')      (1 where that mass <= 1e-30)

    per batch element. A different algorithm from :func:`kl_nmf`, never the
    parity path."""
    return _updates(v, w0, h0, num_iterations, sparsity_alpha, epsilon, safe_div, "float32",
                    True)


def _updates(v, w0, h0, num_iterations, sparsity_alpha, epsilon, div, matmul_dtype, simul):
    """The loop of :func:`kl_nmf` and :func:`kl_nmf_simul`."""
    r = (lambda x: x) if matmul_dtype == "float32" else round_bf16
    v = v.to(torch.float32)
    vq = v.to(torch.bfloat16) if matmul_dtype.startswith("bfloat16_q") else None
    # ΣV per batch element, over the values the ratio reads (nmf_pallas.py:178)
    v_sum = (v if vq is None else vq.to(torch.float32)).sum(dim=(-2, -1)) if simul else None

    def ratio(h, w):
        wh = r(h) @ r(w).transpose(-1, -2)
        if vq is None:
            return div(v, wh)
        ok = wh > _TINY
        rec = (1.0 / torch.where(ok, wh, 1.0)).to(torch.bfloat16)
        return torch.where(ok, vq * rec, 0.0).to(torch.float32)

    w, h = w0.to(torch.float32), h0.to(torch.float32)
    for _ in range(num_iterations):
        q = ratio(h, w)
        h_new = h * (r(q) @ r(w)) / (w.sum(dim=-2, keepdim=True) + sparsity_alpha + epsilon)
        if not simul:  # the W update reads a new Q from the new H
            h = h_new
            q = ratio(h, w)
        w = w * div(r(q).transpose(-1, -2) @ r(h), h.sum(dim=-2, keepdim=True))
        norms = torch.sqrt((w * w).sum(dim=-2, keepdim=True))
        w, h = div(w, norms), h_new * norms
        if simul:  # Σ(WH) = Σ_k (Σ_f W)(Σ_t H), recalibrated to ΣV
            mass = (w.sum(dim=-2) * h.sum(dim=-2)).sum(dim=-1)
            ok = mass > _TINY
            gain = torch.where(ok, v_sum / torch.where(ok, mass, 1.0), 1.0)
            h = h * gain[..., None, None]
    return w, h


def h_infer(
    v: torch.Tensor,
    w: torch.Tensor,
    h0: torch.Tensor,
    num_updates: int,
    sparsity_alpha: float = 0.0,
    epsilon: float = 1e-16,
) -> torch.Tensor:
    """H-only multiplicative updates against a frozen dictionary ``w``
    (F, K): ``H ← H ⊙ (Q·W) / (Σ_f W + α + ε)`` with ``Q = V/(H·Wᵀ)``.

    ``v``: (..., T, F); ``h0``: (..., T, K). The ratio takes the guarded
    divide, so an all-zero frame collapses H to exactly 0 after the first
    update and stays finite (an unguarded 0/0 would make it NaN); frames
    with a positive reconstruction never reach the guard."""
    v = v.to(torch.float32)
    wsum = w.sum(dim=0) + sparsity_alpha + epsilon
    h = h0
    for _ in range(num_updates):
        q = safe_div(v, h @ w.transpose(-1, -2))
        h = h * (q @ w) / wsum
    return h


def kl_divergence(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                  epsilon: float = 1e-12) -> torch.Tensor:
    """Generalized KL divergence D(V ‖ HWᵀ) (scalar, for tests/telemetry),
    in the dtype of ``w`` and ``h`` (pass float64 for a tight reading)."""
    rec = h @ w.transpose(-1, -2)
    v = v.to(rec.dtype)
    return torch.sum(v * (torch.log(v + epsilon) - torch.log(rec + epsilon)) - v + rec)


def order_atoms_by_centroid(w: np.ndarray) -> np.ndarray:
    """Sort dictionary atoms (the columns of a NumPy ``w`` (F, K)) by
    spectral centroid, for display parity with the reference
    (gccNMF/realtime/gccNMFPretraining.py:60-66)."""
    num_freq = w.shape[0]
    centroids = (np.arange(num_freq)[:, None] * w).sum(0) / w.sum(0)
    return w[:, np.argsort(centroids)]
