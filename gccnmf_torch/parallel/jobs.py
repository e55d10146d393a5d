"""Whole jobs for one rank, from global host inputs to global host outputs:
what :func:`~gccnmf_torch.parallel.launch.run_world` runs. Each builds its
mesh over the running world on ``device``, so a caller that holds NumPy
arrays needs no rank code of its own, and a spawned rank imports nothing
but the package."""

from __future__ import annotations

import numpy as np

from gccnmf_torch.parallel import mesh as mesh_lib

__all__ = ["each", "on_mesh", "sharded_nmf", "train", "long_audio"]


def each(calls):
    """Run ``(fn, args, kwargs)`` calls in turn → their results, an
    exception in the place of a call that raised it (only errors that every
    rank raises alike, before any collective, keep the world in step)."""
    out = []
    for fn, args, kwargs in calls:
        try:
            out.append(fn(*args, **kwargs))
        except Exception as e:  # handed back to the caller in the call's place
            out.append(e)
    return out


def on_mesh(fn, data: int, model: int, device, *args, **kwargs):
    """``fn(*args, mesh=<a (data, model) mesh>, **kwargs)``."""
    return fn(*args, mesh=mesh_lib.make_mesh(data, model, device), **kwargs)


def sharded_nmf(v, w0, h0, num_iterations: int, data: int, model: int, device, **kw):
    """``kl_nmf_sharded`` with JAX's calling convention: the global V (T, F),
    W0 (F, K) and H0 (T, K) in, the global (W, H) out, over a (data, model)
    mesh (T divisible by ``data``, K by ``model``)."""
    from gccnmf_torch.parallel.nmf_sharded import kl_nmf_sharded

    mesh = mesh_lib.make_mesh(data, model, device)
    w, h = kl_nmf_sharded(mesh_lib.shard_rows(v, mesh), mesh_lib.shard_rows(w0, mesh, 1, "model"),
                          mesh_lib.shard_rows(h0, mesh), num_iterations, mesh, **kw)
    return mesh_lib.gather_to_host(w, mesh, 1, "model"), mesh_lib.gather_to_host(h, mesh)


def train(train_v: np.ndarray, data: int, model: int, device, **trainer_kw) -> np.ndarray:
    """``DistributedNMFTrainer(mesh, **trainer_kw).fit(train_v)`` over a
    (data, model) mesh."""
    from gccnmf_torch.parallel.trainer import DistributedNMFTrainer

    return DistributedNMFTrainer(mesh_lib.make_mesh(data, model, device), **trainer_kw).fit(train_v)


def long_audio(method: str, args, config, data: int, device, model: int = 1, **sep_kw):
    """``LongAudioSeparator(config, mesh=..., **sep_kw).<method>(*args)``
    over a (data, model) mesh; ``method`` is ``"separate"``,
    ``"separate_streamed"`` or ``"separate_file"``."""
    from gccnmf_torch.parallel.long_audio import LongAudioSeparator

    sep = LongAudioSeparator(config, mesh=mesh_lib.make_mesh(data, model, device), **sep_kw)
    return getattr(sep, method)(*args)
