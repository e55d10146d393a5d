"""Dictionary pre-learning with a disk cache (counterpart of
``gccnmf_tpu/pretrain.py``).

Reference: gccNMF/realtime/gccNMFPretraining.py — pre-learns W for sizes
[64..1024] from a magnitude-spectrogram training corpus, caches to
``pretrainedW/W_<size>.npy``, with a Random-dictionary alternative and
spectral-centroid atom ordering for display.

The cache is the JAX package's, file for file: the same directory
(``GCCNMF_TPU_CACHE_DIR``), the same key
``W_<K>_win<win>_it<iters>_s<seed>_<corpus sha1>.npy`` (every input that
shapes W is in it; the reference keys by size only and silently reused
stale dictionaries), the same atomic publish. A dictionary either package
trained is one the other loads.

Training is :func:`corpus_nmf`: the unguarded plain ``kl_nmf`` on either
device, which is what JAX runs (``nmf_ops.kl_nmf`` with its default
``guard=False``; no Pallas call). So a corpus frame of digital silence
turns W into NaN on the card as on the CPU and in JAX. Kernel 1 always
takes the double-``where`` guards, so it is not this function.
"""

from __future__ import annotations

import hashlib
import logging
import os
from os.path import exists, join
from typing import Mapping

import numpy as np
import torch

from gccnmf_torch import defs
from gccnmf_torch.device import resolve_device
from gccnmf_torch.ops import nmf as nmf_ops
from gccnmf_torch.ops import stft as stft_ops
from gccnmf_torch.ops import windows as win_ops
from gccnmf_torch.parallel import nmf_sharded
from gccnmf_torch.precision import set_fp32_precision

logger = logging.getLogger(__name__)

__all__ = [
    "training_corpus_from_wavs",
    "pretrain_dictionary",
    "get_dictionaries",
    "load_dictionary_file",
    "corpus_nmf",
]

DEFAULT_SIZES = (64, 128, 256, 512, 1024)
NUM_PRETRAIN_ITERATIONS = 100


def _corpus_fingerprint(v: np.ndarray) -> str:
    """SHA-1 of the whole corpus (shape and bytes), 12 hex digits: corpora
    of one shape that differ anywhere get different keys."""
    h = hashlib.sha1()
    h.update(str(v.shape).encode())
    h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()[:12]


def corpus_nmf(v: torch.Tensor, w0: torch.Tensor, h0: torch.Tensor, num_iterations: int,
               sparsity_alpha: float = 0.0, epsilon: float = 1e-16):
    """``num_iterations`` KL-NMF updates of a corpus ``v`` (T, F) from
    ``(w0, h0)``, in exact float32 on ``v``'s device: the unguarded plain
    ``kl_nmf``, JAX's ``nmf.kl_nmf`` (0/0 → NaN on digital silence).
    Returns ``(W, H)``."""
    set_fp32_precision()
    return nmf_ops.kl_nmf(v, w0, h0, num_iterations, sparsity_alpha, epsilon)


def training_corpus_from_wavs(
    wav_paths, window_size: int = 1024, hop_size: int = 512,
    max_frames: int | None = None, device=None,
) -> np.ndarray:
    """A (T, F) float32 magnitude-frame corpus from WAV files (stand-in for
    the reference's missing chimeTrainSet.npy): the sqrt-Hamming STFT of
    every channel on ``device`` (the card by default), frames stacked file
    by file, then cut to ``max_frames`` (default
    ``GCCNMF_TPU_PRETRAIN_MAX_FRAMES`` or 20,000) by a uniform subsample."""
    from gccnmf_torch.utils import wav as wavio

    dev = resolve_device(device)
    if max_frames is None:
        max_frames = int(os.environ.get("GCCNMF_TPU_PRETRAIN_MAX_FRAMES", 20000))
    window = win_ops.sqrt_hamming(window_size)
    frames = []
    for path in wav_paths:
        samples, _ = wavio.read_wav(path)
        spec = stft_ops.stft(torch.as_tensor(samples, device=dev), window, hop_size)
        frames.append(spec.abs().reshape(-1, spec.shape[-1]).cpu().numpy())
    corpus = np.concatenate(frames, axis=0)
    if len(corpus) > max_frames:
        idx = np.linspace(0, len(corpus) - 1, max_frames).astype(int)
        corpus = corpus[idx]
    return np.ascontiguousarray(corpus.astype(np.float32))


def pretrain_dictionary(
    train_v: np.ndarray,
    dictionary_size: int,
    num_iterations: int | None = None,
    cache_dir: str | None = None,
    window_size: int = 1024,
    mesh=None,
    seed_value: int = 0,
    device=None,
) -> np.ndarray:
    """Pre-learn (or load cached) W (F, K) from a (T, F) corpus, on
    ``device`` (the card by default).

    ``num_iterations`` defaults to GCCNMF_TPU_PRETRAIN_ITERS (env) or 100;
    ``cache_dir`` to GCCNMF_TPU_CACHE_DIR (env) or ``defs.PRETRAINED_W_DIR``.
    With ``mesh`` (``parallel.mesh``), every rank of it calls with the same
    corpus and W trains over the mesh's devices
    (``nmf_sharded.pretrain_dictionary_sharded``), ``device`` unused."""
    if num_iterations is None:
        num_iterations = int(
            os.environ.get("GCCNMF_TPU_PRETRAIN_ITERS", NUM_PRETRAIN_ITERATIONS)
        )
    cache_dir = (
        cache_dir or os.environ.get("GCCNMF_TPU_CACHE_DIR") or defs.PRETRAINED_W_DIR
    )
    tag = _corpus_fingerprint(train_v)
    cache_path = join(
        cache_dir,
        f"W_{dictionary_size}_win{window_size}_it{num_iterations}"
        f"_s{seed_value}_{tag}.npy",
    )
    if exists(cache_path):
        logger.info("pretrain: loading cached W from %s", cache_path)
        return np.load(cache_path)

    logger.info(
        "pretrain: training W (K=%d) on %s corpus", dictionary_size, train_v.shape
    )
    if mesh is not None:
        w = nmf_sharded.pretrain_dictionary_sharded(train_v, dictionary_size, num_iterations,
                                                    mesh, seed_value=seed_value)
    else:
        dev = resolve_device(device)
        t, f = train_v.shape
        w0, h0 = nmf_ops.nmf_init_numpy(f, dictionary_size, t, seed_value=seed_value)
        w, _ = corpus_nmf(*(torch.as_tensor(x, device=dev) for x in (train_v, w0, h0)),
                          num_iterations)
        w = w.cpu().numpy()

    os.makedirs(cache_dir, exist_ok=True)
    # atomic publish (tmp + rename): two processes cold-starting on the
    # same key must never read a torn .npy
    tmp_path = f"{cache_path}.{os.getpid()}.tmp.npy"  # .npy: np.save keeps it
    np.save(tmp_path, w)
    os.replace(tmp_path, cache_path)
    return w


def load_dictionary_file(path: str, num_freq: int | None = None) -> np.ndarray:
    """Load an explicit dictionary artifact (.npy, (F, K) nonnegative).

    The production hand-off: ``pretrain --save-dir`` exports these and every
    entry point accepts one via ``--dictionary-file`` / ``dictionaryFile``,
    bypassing the corpus-keyed pretraining cache."""
    w = np.load(path)
    if w.ndim != 2:
        raise ValueError(f"{path}: expected a (F, K) array, got {w.shape}")
    if num_freq is not None and w.shape[0] != num_freq:
        raise ValueError(
            f"{path}: dictionary has {w.shape[0]} frequency rows but the "
            f"configured window expects {num_freq}"
        )
    if np.min(w) < 0:
        raise ValueError(f"{path}: dictionary must be nonnegative")
    return np.ascontiguousarray(w, np.float32)


def get_dictionaries(
    window_size: int = 1024,
    sizes=DEFAULT_SIZES,
    train_v: np.ndarray | None = None,
    ordered: bool = True,
    cache_dir: str | None = None,
    mesh=None,
    rng: np.random.Generator | None = None,
    device=None,
) -> Mapping[str, Mapping[int, np.ndarray]]:
    """Pretrained and Random dictionary banks keyed [type][size] (reference
    getDictionariesW, gccNMFPretraining.py:43-58). Without ``train_v`` the
    corpus is the WAVs of ``defs.DATA_DIR``, else seeded noise frames. With
    ``mesh`` every size trains over it (:func:`pretrain_dictionary`)."""
    rng = rng or np.random.default_rng(0)
    num_freq = window_size // 2 + 1
    if train_v is None:
        candidates = []
        if os.path.isdir(defs.DATA_DIR):
            candidates = [
                join(defs.DATA_DIR, f)
                for f in sorted(os.listdir(defs.DATA_DIR))
                if f.endswith(".wav")
            ]
        if candidates:
            train_v = training_corpus_from_wavs(candidates, window_size, device=device)
        else:
            train_v = (rng.random((4096, num_freq)) + 1e-3).astype(np.float32)

    banks: dict[str, dict[int, np.ndarray]] = {"Pretrained": {}, "Random": {}}
    for size in sizes:
        w = pretrain_dictionary(
            train_v, size, cache_dir=cache_dir, window_size=window_size, mesh=mesh,
            device=device,
        )
        banks["Pretrained"][size] = w
        banks["Random"][size] = rng.random((num_freq, size)).astype(np.float32)
    if ordered:
        banks = {
            t: {s: nmf_ops.order_atoms_by_centroid(w) for s, w in bank.items()}
            for t, bank in banks.items()
        }
    return banks
