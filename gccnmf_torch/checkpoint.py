"""Checkpoint / resume for NMF training runs (counterpart of
``gccnmf_tpu/checkpoint.py``).

Format, the JAX package's: one ``nmf_<iteration>.npz`` per checkpoint (keys
``w``, ``h``, ``iteration`` and ``meta``, a JSON fingerprint of the problem
that refuses a resume against another one), plus a ``latest`` pointer file,
both published atomically (tmp + ``os.replace``). So a checkpoint either
package wrote resumes in the other: the file is how NMF state crosses
between them.
"""

from __future__ import annotations

import json
import logging
import os
from os.path import exists, join

import numpy as np
import torch

from gccnmf_torch.convert import nmf_state_from_numpy
from gccnmf_torch.device import resolve_device
from gccnmf_torch.pretrain import corpus_nmf

logger = logging.getLogger(__name__)

__all__ = [
    "save_nmf_state",
    "load_nmf_state",
    "latest_checkpoint",
    "kl_nmf_checkpointed",
]


def _fingerprint(shapes_meta: dict) -> str:
    return json.dumps(shapes_meta, sort_keys=True)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_nmf_state(
    ckpt_dir: str, w, h, iteration: int, meta: dict | None = None
) -> str:
    """Write ``nmf_<iteration>.npz`` (``w`` and ``h``: tensors or arrays) and
    update the ``latest`` pointer."""
    os.makedirs(ckpt_dir, exist_ok=True)
    w, h = _host(w), _host(h)
    meta = dict(meta or {})
    meta.update(w_shape=list(w.shape), h_shape=list(h.shape))
    path = join(ckpt_dir, f"nmf_{iteration:06d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, w=w, h=h, iteration=iteration, meta=_fingerprint(meta))
    os.replace(tmp, path)  # atomic publish: no torn checkpoints on crash
    # the pointer too: a truncating write killed mid-flight would leave an
    # empty pointer
    pointer_tmp = join(ckpt_dir, "latest.tmp")
    with open(pointer_tmp, "w") as f:
        f.write(os.path.basename(path))
    os.replace(pointer_tmp, join(ckpt_dir, "latest"))
    logger.info("saved NMF checkpoint %s", path)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The checkpoint the ``latest`` pointer names, or None (no pointer, an
    empty one, or a missing file)."""
    pointer = join(ckpt_dir, "latest")
    if not exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    if not name:
        return None
    path = join(ckpt_dir, name)
    return path if os.path.isfile(path) else None


def load_nmf_state(path: str, expect_meta: dict | None = None):
    """Load NumPy ``(w, h, iteration)``. Raises if ``expect_meta`` (the keys
    passed to :func:`save_nmf_state`) does not match what was saved; its
    ``w_shape``/``h_shape`` default to the file's own (not checked)."""
    data = np.load(path, allow_pickle=False)
    if expect_meta is not None:
        expect = dict(expect_meta)
        expect.setdefault("w_shape", list(data["w"].shape))
        expect.setdefault("h_shape", list(data["h"].shape))
        if str(data["meta"]) != _fingerprint(expect):
            raise ValueError(
                f"checkpoint {path} was written for a different problem: "
                f"{data['meta']} vs expected {_fingerprint(expect)}"
            )
    return data["w"], data["h"], int(data["iteration"])


def kl_nmf_checkpointed(
    v,
    w0,
    h0,
    num_iterations: int,
    ckpt_dir: str,
    checkpoint_every: int = 50,
    sparsity_alpha: float = 0.0,
    epsilon: float = 1e-16,
    device=None,
):
    """Run KL-NMF of ``v`` (T, F) from ``(w0, h0)`` (tensors or float32
    arrays) in resumable chunks on ``device`` (the card by default).

    Each chunk of ``checkpoint_every`` iterations is one
    :func:`~gccnmf_torch.pretrain.corpus_nmf` call (the plain unguarded
    updates, as JAX runs them); the state is saved after every chunk. If
    ``ckpt_dir`` already holds a matching checkpoint, training resumes from
    it. Returns the ``(W, H)`` tensors."""
    dev = resolve_device(device)
    v, w0, h0 = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (v, w0, h0))
    # the fingerprint names the problem, not the run: the iteration target
    # may grow between runs (resume and train further)
    meta = dict(
        sparsity_alpha=sparsity_alpha,
        v_shape=list(v.shape),
        w_shape=list(w0.shape),
        h_shape=list(h0.shape),
    )
    w, h, start = w0, h0, 0
    resume = latest_checkpoint(ckpt_dir)
    if resume:
        w_np, h_np, start = load_nmf_state(resume, expect_meta=meta)
        w, h = nmf_state_from_numpy(w_np, h_np, dev)
        logger.info("resuming NMF from iteration %d (%s)", start, resume)
        if start > num_iterations:
            # the fingerprint excludes the iteration target, but a state past
            # it is not "the requested N iterations"
            raise ValueError(
                f"checkpoint in {ckpt_dir} is at iteration {start}, past "
                f"the requested {num_iterations}; point at a fresh "
                f"ckpt_dir to train fewer iterations"
            )
    it = start
    while it < num_iterations:
        chunk = min(checkpoint_every, num_iterations - it)
        w, h = corpus_nmf(v, w, h, chunk, sparsity_alpha, epsilon)
        it += chunk
        save_nmf_state(ckpt_dir, w, h, it, meta=meta)
    return w, h
