"""Distributed KL-NMF: V and H sharded over time, W over atoms (counterpart
of ``gccnmf_tpu/parallel/nmf_sharded.py``).

Written SPMD, as JAX's ``shard_map`` body is: every rank of the mesh calls
:func:`kl_nmf_sharded` with its blocks and gets its blocks back.

- **data axis**: V and H rows (time frames, or a corpus's frames) are split
  over the data ranks. H updates are local; the W update's numerator and
  denominator are all-reduced over ``data`` every iteration.
- **model axis**: W's atoms are split over the model ranks for large
  dictionaries. The reconstruction H·Wᵀ is the all-reduce over ``model`` of
  each rank's partial product, and an updated H atom block is all-gathered
  over ``model``.

With ``model=1`` this is pure data parallelism; on one rank it is
``ops.nmf.kl_nmf`` up to the order of the sums. A collective over an axis
of one rank is skipped, as XLA drops a ``psum`` over an axis of size 1: a
world of one runs no collective, and a data-only mesh none over ``model``
(on an H100 the five collectives of an iteration in a world of one cost
more than the iteration's products). The products are
``torch.matmul`` with TF32 off, as JAX computes them at
``Precision.HIGHEST`` outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gccnmf_torch.ops import nmf as nmf_ops
from gccnmf_torch.parallel import mesh as mesh_lib
from gccnmf_torch.precision import set_fp32_precision

__all__ = ["kl_nmf_sharded", "pad_time", "pretrain_dictionary_sharded"]

_TINY = 1e-30


def pad_time(v: np.ndarray, h0: np.ndarray, multiple: int, epsilon: float = 1e-16):
    """Pad V (T, F) and H0 (T, K) along time to a multiple of ``multiple``
    → ``(v, h0, T)``. The padding rows hold ``epsilon``: they weigh next to
    nothing in W's statistics, where zeros would break the strict
    positivity the multiplicative updates rely on."""
    t = v.shape[0]
    pad = (-t) % multiple
    if pad == 0:
        return v, h0, t
    v_pad = np.full((pad, v.shape[1]), epsilon, v.dtype)
    h_pad = np.full((pad, h0.shape[1]), epsilon, h0.dtype)
    return np.concatenate([v, v_pad]), np.concatenate([h0, h_pad]), t


def kl_nmf_sharded(
    v_l: torch.Tensor,
    w_l: torch.Tensor,
    h_l: torch.Tensor,
    num_iterations: int,
    mesh,
    sparsity_alpha: float = 0.0,
    epsilon: float = 1e-16,
    simultaneous: bool = False,
    guard: bool = False,
):
    """KL-NMF over ``mesh``, called on every rank with its blocks: ``v_l``
    (T/dp, F), the rank's data-axis rows of V; ``w_l`` (F, K/mp), its
    model-axis atoms of W; ``h_l`` (T/dp, K), its rows of H (all atoms).
    Returns this rank's ``(W block (F, K/mp), H rows (T/dp, K))``: JAX's
    out specs ``P(None, "model")`` and ``P("data", None)``.

    The divides are unguarded by default (0/0 → NaN on digital silence, as
    ``kl_nmf``); ``guard=True`` and ``simultaneous=True`` take the
    double-``where`` guards. ``simultaneous=True`` is the turbo updates of
    ``nmf.kl_nmf_simul``: one Q per iteration feeds both updates (one
    reconstruction all-reduce over ``model`` fewer), and H's gain
    ΣV / Σ(WH) comes from two all-reduces of sums."""
    set_fp32_precision()
    data_g, model_g = mesh.get_group("data"), mesh.get_group("model")
    dp, mp = (mesh_lib.axis_size(mesh, a) for a in ("data", "model"))
    k_local = w_l.shape[1]
    if h_l.shape != (v_l.shape[0], k_local * mp) or w_l.shape[0] != v_l.shape[1]:
        raise ValueError(f"blocks V {tuple(v_l.shape)}, W {tuple(w_l.shape)}, H "
                         f"{tuple(h_l.shape)} do not fit a mesh with model={mp}")
    k_start = mesh.get_local_rank("model") * k_local
    div = nmf_ops.safe_div if (simultaneous or guard) else torch.div

    def all_reduce(x: torch.Tensor, group, size: int) -> torch.Tensor:
        if size > 1:
            dist.all_reduce(x, group=group)
        return x

    def gather_atoms(block: torch.Tensor) -> torch.Tensor:
        if mp == 1:
            return block
        parts = [torch.empty_like(block) for _ in range(mp)]
        dist.all_gather(parts, block.contiguous(), group=model_g)
        return torch.cat(parts, dim=1)

    def h_slice(h: torch.Tensor) -> torch.Tensor:
        return h[:, k_start : k_start + k_local]

    def ratio(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return div(v_l, all_reduce(h_slice(h) @ w.T, model_g, mp))

    v_l = v_l.to(torch.float32)
    w, h = w_l.to(torch.float32), h_l.to(torch.float32)
    # the global mass of V, for the turbo gain
    v_sum = all_reduce(v_l.sum(), data_g, dp) if simultaneous else None
    for _ in range(num_iterations):
        q = ratio(h, w)
        h_block = h_slice(h) * (q @ w) / (w.sum(dim=0) + sparsity_alpha + epsilon)
        if simultaneous:
            h_blk = h_slice(h)  # the W update reads the pre-update H and the same Q
        else:
            h = gather_atoms(h_block)
            q = ratio(h, w)
            h_blk = h_slice(h)
        num_w = all_reduce(q.T @ h_blk, data_g, dp)
        den_w = all_reduce(h_blk.sum(dim=0), data_g, dp)
        w = w * div(num_w, den_w)
        norms = torch.sqrt((w * w).sum(dim=0))
        w = div(w, norms)
        h_block = (h_block if simultaneous else h_blk) * norms
        if simultaneous:  # Σ(WH) = Σ_k (Σ_f W)(Σ_t H), recalibrated to ΣV
            sh = all_reduce(h_block.sum(dim=0), data_g, dp)
            mass = all_reduce((w.sum(dim=0) * sh).sum(), model_g, mp)
            ok = mass > _TINY
            h_block = h_block * torch.where(ok, v_sum / torch.where(ok, mass, 1.0), 1.0)
        h = gather_atoms(h_block)
    return w, h


def pretrain_dictionary_sharded(
    train_v: np.ndarray,
    dictionary_size: int,
    num_iterations: int,
    mesh,
    sparsity_alpha: float = 0.0,
    epsilon: float = 1e-16,
    seed_value: int = 0,
) -> np.ndarray:
    """Dictionary pre-learning over ``mesh`` from a (T, F) magnitude corpus
    that every rank holds: time padded to the data axis, the reference's
    seeded init, the unguarded updates. Returns W (F, K) on every rank."""
    t, f = train_v.shape
    w0, h0 = nmf_ops.nmf_init_numpy(f, dictionary_size, t, epsilon, seed_value)
    v_p, h0_p, _ = pad_time(train_v.astype(np.float32), h0, mesh_lib.axis_size(mesh, "data"),
                            epsilon)
    w, _ = kl_nmf_sharded(
        mesh_lib.shard_rows(v_p, mesh), mesh_lib.shard_rows(w0, mesh, 1, "model"),
        mesh_lib.shard_rows(h0_p, mesh), num_iterations, mesh, sparsity_alpha, epsilon)
    return mesh_lib.gather_to_host(w, mesh, 1, "model")
