"""Resumable dictionary training over a process group (counterpart of
``gccnmf_tpu/parallel/trainer.py``).

:func:`~gccnmf_torch.parallel.nmf_sharded.kl_nmf_sharded` (V and H over
time, W over atoms) in chunks of iterations, with the checkpoints of
:mod:`gccnmf_torch.checkpoint` between them: how a dictionary is learned
from a corpus larger than one card, or in a run longer than one job.
"""

from __future__ import annotations

import logging

import numpy as np
import torch.distributed as dist

from gccnmf_torch import checkpoint as ckpt
from gccnmf_torch.ops import nmf as nmf_ops
from gccnmf_torch.parallel import mesh as mesh_lib
from gccnmf_torch.parallel.nmf_sharded import kl_nmf_sharded, pad_time

logger = logging.getLogger(__name__)

__all__ = ["DistributedNMFTrainer"]


class DistributedNMFTrainer:
    """Resumable sharded KL-NMF dictionary training over a device mesh.
    Every rank of the mesh builds one and calls :meth:`fit`."""

    @classmethod
    def for_deployment(cls, model: int = 1, device=None, **kwargs) -> "DistributedNMFTrainer":
        """A trainer on the mesh of the whole deployment:
        :func:`~gccnmf_torch.parallel.mesh.init_distributed` (torchrun's
        variables, or a no-op in one process), then
        :func:`~gccnmf_torch.parallel.mesh.multihost_mesh` on ``device``
        (the card by default)."""
        mesh_lib.init_distributed(device=device)
        return cls(mesh_lib.multihost_mesh(model=model, device=device), **kwargs)

    def __init__(
        self,
        mesh,
        dictionary_size: int,
        num_iterations: int = 100,
        checkpoint_every: int = 50,
        checkpoint_dir: str | None = None,
        sparsity_alpha: float = 0.0,
        epsilon: float = 1e-16,
        seed_value: int = 0,
    ):
        self.mesh = mesh
        self.dictionary_size = dictionary_size
        self.num_iterations = num_iterations
        self.checkpoint_every = checkpoint_every
        self.checkpoint_dir = checkpoint_dir
        self.sparsity_alpha = sparsity_alpha
        self.epsilon = epsilon
        self.seed_value = seed_value

    def _gather(self, w_l, h_l) -> tuple[np.ndarray, np.ndarray]:
        """The global (W, H) on every rank."""
        return (mesh_lib.gather_to_host(w_l, self.mesh, 1, "model"),
                mesh_lib.gather_to_host(h_l, self.mesh, 0, "data"))

    def fit(self, train_v: np.ndarray) -> np.ndarray:
        """Train W (F, K) on a (T, F) magnitude corpus that every rank
        holds, resuming from the latest checkpoint in ``checkpoint_dir``
        when its fingerprint matches (another problem raises). Rank 0
        alone writes each checkpoint, and a barrier follows, so with
        ``checkpoint_dir`` on a filesystem every rank sees, a resume on any
        rank finds it. Returns W on every rank."""
        mesh = self.mesh
        dp, mp = (mesh_lib.axis_size(mesh, a) for a in ("data", "model"))
        t, f = train_v.shape
        w_host, h_host = nmf_ops.nmf_init_numpy(f, self.dictionary_size, t, self.epsilon,
                                                self.seed_value)
        v_p, h_p, _ = pad_time(train_v.astype(np.float32), h_host, dp, self.epsilon)

        # the problem's fingerprint: the iteration target may grow on resume
        meta = dict(
            sparsity_alpha=self.sparsity_alpha,
            epsilon=self.epsilon,
            v_shape=list(train_v.shape),
            w_shape=list(w_host.shape),  # pins dictionary_size on resume
            h_shape=list(h_p.shape),
            mesh=[dp, mp],
            seed=self.seed_value,
        )
        start = 0
        if self.checkpoint_dir:
            resume = ckpt.latest_checkpoint(self.checkpoint_dir)
            if resume:
                w_host, h_p, start = ckpt.load_nmf_state(resume, expect_meta=meta)
                logger.info("resuming sharded NMF at iteration %d", start)

        v_l = mesh_lib.shard_rows(v_p, mesh)
        w_l = mesh_lib.shard_rows(w_host, mesh, 1, "model")
        h_l = mesh_lib.shard_rows(h_p, mesh)
        it = start
        while it < self.num_iterations:
            chunk = min(self.checkpoint_every, self.num_iterations - it)
            w_l, h_l = kl_nmf_sharded(v_l, w_l, h_l, chunk, mesh, self.sparsity_alpha,
                                      self.epsilon)
            it += chunk
            if self.checkpoint_dir:
                w_np, h_np = self._gather(w_l, h_l)
                if dist.get_rank() == 0:
                    ckpt.save_nmf_state(self.checkpoint_dir, w_np, h_np, it, meta=meta)
                dist.barrier()
        return mesh_lib.gather_to_host(w_l, mesh, 1, "model")
