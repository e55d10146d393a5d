"""Move state made on the JAX side (as NumPy arrays) into the port's tensors.

The seeded NMF init (``nmf_init_numpy``), the steering planes
(``gcc.steering_cos_sin``), the analysis window and a learned dictionary are
all host NumPy arrays in the JAX package; so are the leaves of a streaming
``StreamState`` once fetched, and the factors of an NMF checkpoint. These
functions check each one's dtype and shape before it becomes a tensor on
``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from gccnmf_torch.models.realtime import StreamState

__all__ = ["from_numpy_state", "nmf_state_from_numpy", "stream_state_from_numpy"]

# key → required rank (a leading batch axis is allowed on the NMF state)
_RANKS = {"w0": (2, 3), "h0": (2, 3), "cos": (2,), "sin": (2,), "window": (1,), "w": (2,)}


def from_numpy_state(arrays: dict, device="cpu") -> dict:
    """``{"w0", "h0", "cos", "sin", "window", "w"}`` NumPy float32 arrays →
    the same keys as float32 tensors on ``device``. Every key is optional;
    unknown keys, non-float32 dtypes and inconsistent shapes raise.

    Shapes: ``w0`` (..., F, K); ``h0`` (..., T, K); ``cos``/``sin`` (F, D);
    ``window`` (win,); ``w`` (F, K), a learned dictionary."""
    unknown = set(arrays) - set(_RANKS)
    if unknown:
        raise KeyError(f"unknown state keys {sorted(unknown)}: want {sorted(_RANKS)}")
    out = {}
    for key, arr in arrays.items():
        arr = np.asarray(arr)
        if arr.dtype != np.float32:
            raise TypeError(f"{key}: expected float32, got {arr.dtype}")
        if arr.ndim not in _RANKS[key]:
            raise ValueError(f"{key}: expected rank {_RANKS[key]}, got shape {arr.shape}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    if "w0" in out and "h0" in out and out["w0"].shape[-1] != out["h0"].shape[-1]:
        raise ValueError("w0 and h0 disagree on the dictionary size K")
    if "cos" in out and "sin" in out and out["cos"].shape != out["sin"].shape:
        raise ValueError("cos and sin steering planes disagree in shape")
    f = {out[k].shape[-2] for k in ("w0", "w") if k in out}
    f |= {out[k].shape[0] for k in ("cos", "sin") if k in out}
    if "window" in out:
        f.add(out["window"].shape[0] // 2 + 1)
    if len(f) > 1:
        raise ValueError(f"frequency bins disagree across the state: {sorted(f)}")
    return out


def nmf_state_from_numpy(w, h, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The factors of an NMF state (a checkpoint's ``w`` (F, K) and ``h``
    (T, K), float32 NumPy arrays) → float32 tensors on ``device``. Another
    dtype, another rank and a dictionary size K that disagrees raise."""
    out = []
    for key, arr in (("w", w), ("h", h)):
        arr = np.asarray(arr)
        if arr.dtype != np.float32:
            raise TypeError(f"{key}: expected float32, got {arr.dtype}")
        if arr.ndim != 2:
            raise ValueError(f"{key}: expected rank 2, got shape {arr.shape}")
        # a copy: the caller keeps its array
        out.append(torch.from_numpy(np.array(arr)).to(device))
    if out[0].shape[1] != out[1].shape[1]:
        raise ValueError(f"w {tuple(out[0].shape)} and h {tuple(out[1].shape)} disagree on K")
    return out[0], out[1]


# StreamState leaf → (dtype, rank); every leaf leads with the stream batch B
_STREAM_LEAVES = {
    "carry_in": (np.float32, 3),  # (B, C, window - hop)
    "ola_acc": (np.float32, 3),  # (B, C, ola_length)
    "gcc_history": (np.float32, 3),  # (B, history, D)
    "hist_count": (np.int32, 1),  # (B,)
    "target_idx": (np.float32, 1),  # (B,)
    "delay_buf": (np.float32, 4),  # (B, C, extra_delay_blocks, block); may be 0 long
}


def stream_state_from_numpy(leaves, device="cpu") -> StreamState:
    """A streaming state fetched from the JAX engine (a ``StreamState`` of
    NumPy arrays, or a mapping of its field names) → the port's
    :class:`StreamState` on ``device``. Missing or unknown leaves, another
    dtype, another rank and a batch or channel count that disagrees across
    leaves raise. ``delay_buf`` may have a zero-length FIFO axis."""
    if hasattr(leaves, "_asdict"):
        leaves = leaves._asdict()
    leaves = dict(leaves)
    if set(leaves) != set(_STREAM_LEAVES):
        raise KeyError(f"stream state leaves {sorted(leaves)}: want {sorted(_STREAM_LEAVES)}")
    out = {}
    for key, (dtype, rank) in _STREAM_LEAVES.items():
        arr = np.asarray(leaves[key])
        if arr.dtype != dtype:
            raise TypeError(f"{key}: expected {np.dtype(dtype).name}, got {arr.dtype}")
        if arr.ndim != rank:
            raise ValueError(f"{key}: expected rank {rank}, got shape {arr.shape}")
        out[key] = torch.from_numpy(np.array(arr)).to(device)  # a copy: JAX's are read-only
    batch = {v.shape[0] for v in out.values()}
    if len(batch) > 1:
        raise ValueError(f"stream batch disagrees across the state: {sorted(batch)}")
    channels = {out[k].shape[1] for k in ("carry_in", "ola_acc", "delay_buf")}
    if len(channels) > 1:
        raise ValueError(f"channel count disagrees across the state: {sorted(channels)}")
    return StreamState(**out)
