"""Offline GCC-NMF blind separation and enhancement on PyTorch (counterpart
of ``gccnmf_tpu/models/offline.py``, the reference's ``runGCCNMF.py``).

Separation (reference: gccNMF/runGCCNMF.py:30-54): stereo mixture → STFT →
unsupervised KL-NMF on concatenated |X| → GCC-PHAT angular spectrogram →
TDOA peak picking → per-atom attribution → hard coefficient masks → masked
reconstruction with mixture phase → ISTFT.

Enhancement (``GCCNMFEnhancer``, a pre-learned dictionary): STFT and
GCC-PHAT → target TDOA at the peak of the mean angular spectrum → each
atom's argmax TDOA per frame → soft coefficient mask around the target →
Wiener TF mask → ISTFT.

On a CUDA device the heavy stages run through the port's hand-written
kernels (``ops/frontend_cuda.py``, ``ops/nmf_cuda.py``,
``ops/synthesis_cuda.py``, ``ops/enhance_cuda.py``) and the batched core
stays on planes, with no complex intermediates. On the CPU the plain torch
path mirrors the JAX package's XLA path. Peak picking and the attribution
winner are torch ops on either device, as they are XLA ops in JAX.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace

import numpy as np
import torch

from gccnmf_torch.convert import from_numpy_state
from gccnmf_torch.device import resolve_device
from gccnmf_torch.ops import gcc, localize, masks, stft as stft_ops
from gccnmf_torch.ops.enhance_cuda import (
    soft_mask_basis, soft_mask_cuda, tf_synthesis_basis, tf_synthesis_cuda,
)
from gccnmf_torch.ops.frontend_cuda import frontend_basis, stft_gcc_frontend_cuda
from gccnmf_torch.ops.nmf import h_infer, kl_nmf, kl_nmf_simul, nmf_init_numpy
from gccnmf_torch.ops.nmf_cuda import kl_nmf_cuda, nmf_mode
from gccnmf_torch.ops.synthesis_cuda import masked_synthesis_cuda, synthesis_basis
from gccnmf_torch.ops.windows import hann_symmetric
from gccnmf_torch.precision import set_fp32_precision
from gccnmf_torch.utils import wav
from gccnmf_torch.utils.hostmem import PeriodicTrim

logger = logging.getLogger(__name__)

__all__ = [
    "OfflineConfig", "GCCNMFSeparator", "GCCNMFEnhancer", "stft_gain", "gemm_dtype",
    "plane_dtype",
]

BACKENDS = ("auto", "torch", "cuda")


def _resolve_backend(name: str, value: str, device: torch.device) -> str:
    if value not in BACKENDS:
        raise ValueError(f"{name}={value!r}: want one of {BACKENDS}")
    if value == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if value == "cuda" and device.type != "cuda":
        raise ValueError(f"{name}='cuda' asks for the CUDA kernel on a {device.type} device")
    return value


@dataclass(frozen=True)
class OfflineConfig:
    """Offline pipeline parameters: the same fields and defaults as the JAX
    package's (which match runGCCNMF.py:56-77).

    ``nmf_backend``, ``synthesis_backend`` and ``frontend_backend`` are
    ``"auto" | "torch" | "cuda"``. ``"auto"`` picks the hand-written kernel
    for all three stages on a CUDA device, in every ported mode, and the
    plain torch path on the CPU. Unlike JAX's ``"auto"``, which keeps the XLA
    front-end in float32 parity mode, the port uses its front-end kernel
    there too: in float32 it computes the same planes to fp32 rounding.

    ``nmf_matmul_dtype``: ``"bfloat16_q"`` (default; V and Q held in bf16
    inside the NMF loop), ``"bfloat16"`` (bf16 GEMM operands, fp32
    accumulation), ``"float32"`` (exact, the parity mode) or
    ``"bfloat16_q_simul"`` (turbo: ``"bfloat16_q"``'s rounding with
    simultaneous updates from one Q an iteration, a different algorithm,
    never the parity path; the plain path runs it in fp32, as
    ``nmf.kl_nmf_simul``). The other kernels run bf16 GEMMs in every bf16
    mode (:func:`gemm_dtype`).
    """

    window_size: int = 1024
    hop_size: int = 128
    num_tdoas: int = 128
    mic_separation_m: float = 1.0
    dictionary_size: int = 128
    num_iterations: int = 100
    sparsity_alpha: float = 0.0
    num_sources: int | None = 3
    sample_rate: int = 16000
    stft_method: str = "auto"  # "auto" | "fft" | "matmul" | "conv"
    nmf_backend: str = "auto"  # "auto" | "torch" | "cuda"
    nmf_matmul_dtype: str = "bfloat16_q"
    synthesis_backend: str = "auto"  # "auto" | "torch" | "cuda"
    frontend_backend: str = "auto"  # "auto" | "torch" | "cuda"
    epsilon: float = 1e-16

    @property
    def num_freq(self) -> int:
        return self.window_size // 2 + 1

    def resolved_stft_method(self) -> str:
        """'auto' → torch.fft on either device (the plain path's STFT)."""
        return "fft" if self.stft_method == "auto" else self.stft_method

    def resolved_nmf_backend(self, device: torch.device) -> str:
        return _resolve_backend("nmf_backend", self.nmf_backend, device)

    def resolved_frontend_backend(self, device: torch.device) -> str:
        return _resolve_backend("frontend_backend", self.frontend_backend, device)

    def resolved_synthesis_backend(self, device: torch.device) -> str:
        return _resolve_backend("synthesis_backend", self.synthesis_backend, device)


def stft_gain(cfg: OfflineConfig) -> float:
    """The reference's constant reconstruction gain hop/window*2
    (gccNMFFunctions.py:155)."""
    return cfg.hop_size / float(cfg.window_size) * 2.0


def gemm_dtype(cfg: OfflineConfig) -> str:
    """GEMM operand dtype for the non-NMF kernels: the NMF-only
    "bfloat16_q" mode maps to plain bf16 GEMMs everywhere else."""
    md = cfg.nmf_matmul_dtype
    return "bfloat16" if md in ("bfloat16_q", "bfloat16_q_simul") else md


def plane_dtype(cfg: OfflineConfig) -> str:
    """Storage dtype of the front-end's spec/V/coherence planes: bf16 in the
    throughput modes, fp32 in float32 parity mode."""
    return "bfloat16" if gemm_dtype(cfg) == "bfloat16" else "float32"


class GCCNMFSeparator:
    """Blind stereo source separation.

    ``device=None`` means CUDA, and raises when there is no card; pass
    ``device="cpu"`` to run the plain torch path on the CPU."""

    def __init__(self, config: OfflineConfig = OfflineConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        set_fp32_precision()
        nmf_mode(config.nmf_matmul_dtype)  # raises for an unknown mode
        self._stft_method = config.resolved_stft_method()
        self._nmf_backend = config.resolved_nmf_backend(self.device)
        self._synthesis_backend = config.resolved_synthesis_backend(self.device)
        self._frontend_backend = config.resolved_frontend_backend(self.device)
        window = hann_symmetric(config.window_size)
        cos_m, sin_m = gcc.steering_cos_sin(
            float(config.sample_rate), config.num_freq,
            config.mic_separation_m, config.num_tdoas,
        )
        state = from_numpy_state({"window": window, "cos": cos_m, "sin": sin_m}, self.device)
        self._window, self._cos, self._sin = state["window"], state["cos"], state["sin"]
        if self._frontend_backend == "cuda":
            self._dft_basis = frontend_basis(window, conjugate=True, device=self.device,
                                             matmul_dtype=gemm_dtype(config),
                                             steering=(self._cos, self._sin))
        if self._synthesis_backend == "cuda":
            self._idft_basis = synthesis_basis(window, stft_gain(config), gemm_dtype(config),
                                               device=self.device)

    # ---- stages -----------------------------------------------------------

    def _init_nmf(self, n: int, batch: tuple[int, ...] = ()):
        """Reference-seeded (W0, H0) for a length-n signal, broadcast over
        ``batch``."""
        cfg = self.config
        t = stft_ops.num_frames(n, cfg.window_size, cfg.hop_size)
        w0, h0 = nmf_init_numpy(cfg.num_freq, cfg.dictionary_size, 2 * t, cfg.epsilon)
        state = from_numpy_state({"w0": w0, "h0": h0}, self.device)
        return (state["w0"].expand(*batch, *w0.shape), state["h0"].expand(*batch, *h0.shape))

    def _run_nmf(self, v, w0, h0):
        cfg = self.config
        args = (cfg.num_iterations, cfg.sparsity_alpha, cfg.epsilon)
        if self._nmf_backend == "cuda":
            return kl_nmf_cuda(v, w0, h0, *args, matmul_dtype=cfg.nmf_matmul_dtype)
        # the turbo algorithm runs off the kernel too, in fp32, as JAX's XLA
        # path does (offline.py:199-204)
        plain = kl_nmf_simul if cfg.nmf_matmul_dtype == "bfloat16_q_simul" else kl_nmf
        return plain(v.to(torch.float32), w0, h0, *args)

    def _analyze_planes(self, stereo, w0, h0):
        """Analysis on planes: ``(spec_re, spec_im, W, H, coh_re, coh_im,
        ang)`` for ``stereo`` (..., 2, n). On the front-end kernel the planes
        come straight from it (fp32 or bf16); no complex tensor exists."""
        cfg = self.config
        if self._frontend_backend == "cuda":
            sre, sim, vp, cre, cim, ang = stft_gcc_frontend_cuda(
                stereo, self._dft_basis, self._cos, self._sin, hop_size=cfg.hop_size,
                matmul_dtype=gemm_dtype(cfg), plane_dtype=plane_dtype(cfg),
            )
            # (..., 2, T, F) → (..., 2T, F): left‖right along time
            # (runGCCNMF.py:40) is a free reshape in this layout
            v = vp.reshape(*vp.shape[:-3], -1, vp.shape[-1])
            w, h = self._run_nmf(v, w0, h0)
            return sre, sim, w, h, cre, cim, ang
        spec = stft_ops.stft(
            stereo, self._window, cfg.hop_size, conjugate=True, method=self._stft_method
        )  # (..., 2, T, F)
        v = torch.cat([spec[..., 0, :, :].abs(), spec[..., 1, :, :].abs()], dim=-2)
        w, h = self._run_nmf(v, w0, h0)
        coh = gcc.coherence(spec)
        ang = gcc.angular_spectrogram(coh, self._cos, self._sin)
        return spec.real, spec.imag, w, h, coh.real, coh.imag, ang

    def _reconstruct_one(self, spec, coh, w, h_stereo, targets):
        """Plain tail for one utterance: attribution → hard masks → masked
        reconstruction → ISTFT. Returns (estimates (N, 2, n_out), winner
        (T, K))."""
        cfg = self.config
        scores = masks.target_attribution(coh, self._cos, self._sin, targets, w)
        coef_masks = masks.hard_coefficient_masks(scores)
        spec_est = masks.masked_reconstruction(coef_masks, spec, w, h_stereo)
        est = stft_ops.istft(
            spec_est, self._window, cfg.hop_size, conjugate=True, center_trim=True,
            method=self._stft_method,
        )
        return est * stft_gain(cfg), coef_masks.argmax(dim=0).to(torch.int32)

    def _reconstruct_planes(self, sre, sim, cre, cim, w, h, targets):
        """Batched reconstruction tail on planes → ``(estimates (B, N, 2,
        n_out), winner (B, T, K) int32)``. On the synthesis kernel the
        flat-GEMM attribution argmax feeds it directly: neither one-hot masks
        nor complex estimates exist."""
        cfg = self.config
        t = sre.shape[-2]
        h_stereo = torch.stack([h[..., :t, :], h[..., t:, :]], dim=-3)
        if self._synthesis_backend == "cuda":
            winner = masks.attribution_winner_planes(cre, cim, self._cos, self._sin, targets, w)
            est = masked_synthesis_cuda(
                sre, sim, winner, w, h_stereo, self._idft_basis,
                num_targets=targets.shape[-1], hop_size=cfg.hop_size,
                matmul_dtype=gemm_dtype(cfg),
            )
            return est, winner
        f = cfg.num_freq
        spec = torch.complex(sre[..., :f].float(), sim[..., :f].float())
        coh = torch.complex(cre[..., :f].float(), cim[..., :f].float())
        outs = [
            self._reconstruct_one(spec[i], coh[i], w[i], h_stereo[i], targets[i])
            for i in range(spec.shape[0])
        ]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    def _stereo(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # ---- public API -------------------------------------------------------

    @torch.inference_mode()
    def separate(self, stereo: np.ndarray, num_sources: int | None = None):
        """Separate a (2, n) float32 mixture → dict with ``estimates``
        (num_targets, 2, n_out), ``target_tdoa_indexes``, ``angular``,
        ``w``, ``h``, ``coefficient_masks`` (num_targets, T, K), as NumPy.
        With no source count (here or in the config) the count comes from
        2-means on the angular-spectrum peak heights."""
        num_sources = self.config.num_sources if num_sources is None else num_sources
        x = self._stereo(stereo)[None]
        w0, h0 = self._init_nmf(x.shape[-1], (1,))
        sre, sim, w, h, cre, cim, ang = self._analyze_planes(x, w0, h0)
        mean_ang = gcc.mean_angular_spectrum(ang[0]).cpu().numpy()
        targets = localize.estimate_target_tdoa_indexes(mean_ang, num_sources)
        targets_t = torch.tensor([targets], dtype=torch.int32, device=self.device)
        est, winner = self._reconstruct_planes(sre, sim, cre, cim, w, h, targets_t)
        return dict(
            estimates=est[0].cpu().numpy(),
            target_tdoa_indexes=targets,
            angular=ang[0].cpu().numpy(),
            w=w[0].cpu().numpy(),
            h=h[0].cpu().numpy(),
            coefficient_masks=masks.winner_one_hot(winner[0], len(targets)).cpu().numpy(),
        )

    def separate_file(
        self,
        mixture_path: str,
        output_prefix: str | None = None,
        audio: tuple[np.ndarray, int] | None = None,
    ):
        """Separate ``<prefix>_mix.wav`` → ``<prefix>_sim_<n>.wav`` files
        (naming per reference gccNMFFunctions.py:43-45). Pass ``audio`` as
        ``(stereo, sample_rate)`` to skip re-reading an already-loaded
        file."""
        stereo, sr = audio if audio is not None else wav.read_wav(mixture_path)
        sep = self
        if sr != self.config.sample_rate:
            sep = GCCNMFSeparator(replace(self.config, sample_rate=sr), device=self.device)
        result = sep.separate(stereo)
        prefix = output_prefix or wav.default_output_prefix(mixture_path)
        paths = []
        for i, est in enumerate(result["estimates"]):
            path = f"{prefix}_sim_{i + 1}.wav"
            wav.write_wav(est, path, sr)
            paths.append(path)
        result["paths"] = paths
        return result

    def _separate_batch_core(self, stereo, w0, h0, num_sources: int | None,
                             max_sources: int = 4):
        """The whole path on planes for a batch ``(B, 2, n)``, peak picking
        on the device: ``(estimates, targets (B, N), counts (B,))``. With a
        fixed ``num_sources`` the targets are the top-k peaks and ``counts``
        the peaks found; with ``None``, :func:`localize.auto_count_targets`
        picks up to ``max_sources`` and ``counts`` is how many it kept."""
        sre, sim, w, h, cre, cim, ang = self._analyze_planes(stereo, w0, h0)
        mean_ang = gcc.mean_angular_spectrum(ang)
        if num_sources:
            targets = localize.top_k_peaks(mean_ang, num_sources)
            counts = localize.peak_count(mean_ang)
        else:
            targets, counts = localize.auto_count_targets(mean_ang, max_sources)
        est, _ = self._reconstruct_planes(sre, sim, cre, cim, w, h, targets)
        return est, targets, counts

    def _separate_batch_i16(self, stereo_i16, w0, h0, num_sources: int):
        """The int16-in, int16-out program: the PCM↔float conversions of
        ``utils/wav.py`` on the device, so the host link carries 16-bit
        samples both ways. The cast truncates after the clamp, as JAX's
        ``astype`` does."""
        stereo = stereo_i16.to(torch.float32) / 32768.0
        est, targets, counts = self._separate_batch_core(stereo, w0, h0, num_sources)
        return torch.clamp(est * 32768.0, -32768, 32767).to(torch.int16), targets, counts

    @torch.inference_mode()
    def separate_batch(
        self,
        stereo_batch: np.ndarray,
        num_sources: int | None = None,
        max_sources: int = 4,
    ):
        """Separate a batch ``(B, 2, n)`` on the device, as NumPy.

        With a fixed source count (given here or via the config): device
        top-k peak picking; returns ``(estimates (B, N, 2, n_out), targets
        (B, N))``. Utterances with fewer angular-spectrum peaks than
        ``num_sources`` get duplicated targets (the host path raises
        instead) and are reported with a warning.

        With ``num_sources=None`` (here and in the config): source counting
        on the device (:func:`localize.auto_count_targets`); returns
        ``(estimates (B, max_sources, 2, n_out), targets, counts (B,))``,
        where rows ``[0, counts[b])`` are the detected sources
        left-to-right and the rest silent pads."""
        num_sources = self.config.num_sources if num_sources is None else num_sources
        x = self._stereo(stereo_batch)
        w0, h0 = self._init_nmf(x.shape[-1], (x.shape[0],))
        est, targets, counts = self._separate_batch_core(x, w0, h0, num_sources, max_sources)
        if not num_sources:
            return est.cpu().numpy(), targets.cpu().numpy(), counts.cpu().numpy()
        short = np.flatnonzero(counts.cpu().numpy() < num_sources)
        if short.size:
            logger.warning(
                "separate_batch: %d utterance(s) (e.g. index %d) had fewer "
                "than %d angular-spectrum peaks; their missing targets "
                "duplicate the dominant peak",
                short.size, int(short[0]), num_sources,
            )
        return est.cpu().numpy(), targets.cpu().numpy()

    @torch.inference_mode()
    def separate_batches(self, batches, num_sources: int | None = None,
                         io_dtype: str = "float32"):
        """Pipelined separation over an iterable of ``(B, 2, n)`` chunks.

        Yields ``(estimates, targets)`` per chunk, as :meth:`separate_batch`
        returns them for a fixed source count. On the card the host↔device
        copies overlap the compute: while chunk k computes on the current
        stream, chunk k+1 uploads from pinned memory and chunk k−1's
        results download into pinned memory, both on a copy stream ordered
        by CUDA events. Every yielded array is the caller's own: no later
        chunk writes into it. On the CPU the same loop runs without
        streams.

        ``io_dtype="int16"`` runs the int16 program: 16-bit samples both
        ways, the estimates quantized as ``utils/wav.write_wav`` would and
        returned as float32 in [-1, 1)."""
        cfg = self.config
        num_sources = cfg.num_sources if num_sources is None else num_sources
        if not num_sources:
            raise ValueError("separate_batches needs a fixed num_sources")
        if io_dtype not in ("float32", "int16"):
            raise ValueError(f"io_dtype must be float32 or int16: {io_dtype}")
        run = self._separate_batch_i16 if io_dtype == "int16" else self._separate_batch_core
        cuda = self.device.type == "cuda"
        compute = torch.cuda.current_stream(self.device) if cuda else None
        copy = torch.cuda.Stream(self.device) if cuda else None
        inits: dict = {}  # per (B, n): the seeded NMF init
        trimmer = PeriodicTrim()  # bounds the loop's own host-heap churn

        def upload(chunk):
            """Chunk to the device: on the card through a pinned copy of it,
            sent on the copy stream, with the event that marks its arrival.
            Float samples bound for the int16 program are scaled and clamped
            here; the cast into the staging buffer truncates, as JAX's
            ``astype`` does."""
            chunk = np.asarray(chunk)
            if io_dtype == "int16" and chunk.dtype != np.int16:
                chunk = np.multiply(chunk, 32768.0, dtype=np.float32)
                np.clip(chunk, -32768, 32767, out=chunk)
            dtype = torch.int16 if io_dtype == "int16" else torch.float32
            host = torch.empty(chunk.shape, dtype=dtype, pin_memory=cuda)
            np.copyto(host.numpy(), chunk, casting="unsafe")
            trimmer.account(host.nbytes)
            if not cuda:
                return host, None
            with torch.cuda.stream(copy):  # allocated on the copy stream
                x = host.to(self.device, non_blocking=True)
            return x, copy.record_event()

        def download(outs):
            """Results to pinned host memory on the copy stream, once the
            compute stream has made them."""
            if not cuda:
                return outs, None
            copy.wait_event(compute.record_event())
            with torch.cuda.stream(copy):
                host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True).copy_(
                    o, non_blocking=True) for o in outs]
            for o in outs:  # not reused by the compute stream before the copy ends
                o.record_stream(copy)
            return host, copy.record_event()

        def materialize(pending):
            (est, targets), done = pending
            if done is not None:
                done.synchronize()
            est = est.numpy()
            trimmer.account(est.nbytes)
            if io_dtype == "int16":  # a new array, scaled as utils/wav reads PCM
                est = np.multiply(est, np.float32(1 / 32768), dtype=np.float32)
            elif cuda:  # the caller's own copy; the pinned block goes back to the cache
                est = est.copy()
            return est, targets.numpy().copy()

        chunks = iter(batches)
        nxt = next(chunks, None)
        up = None if nxt is None else upload(nxt)
        prev = None
        while up is not None:
            x, arrived = up
            if cuda:
                compute.wait_event(arrived)
                x.record_stream(compute)
            key = (x.shape[0], x.shape[-1])
            if key not in inits:
                inits[key] = self._init_nmf(x.shape[-1], (x.shape[0],))
            est, targets, _ = run(x, *inits[key], num_sources)
            nxt = next(chunks, None)  # chunk k+1 uploads while chunk k computes
            up = None if nxt is None else upload(nxt)
            pending = download((est, targets))
            if prev is not None:
                yield materialize(prev)
            prev = pending
        if prev is not None:
            yield materialize(prev)


class GCCNMFEnhancer:
    """Offline speech enhancement with a pre-learned dictionary ``w``
    (F, K): a soft generalized-Gaussian coefficient mask around the
    localized target TDOA and a Wiener TF mask give one enhanced stereo
    output (the offline analogue of the reference's realtime path,
    gccNMFProcessor.py:259-269).

    ``device=None`` means CUDA, and raises when there is no card; pass
    ``device="cpu"`` to run the plain torch path on the CPU. The backend
    switches are the separator's: on CUDA, ``"auto"`` runs the front-end
    kernel, ``soft_mask_cuda`` for the coefficient mask and
    ``tf_synthesis_cuda`` for the Wiener-masked ISTFT.

    With ``num_h_updates > 0`` the Wiener mask weighs each atom by H
    inferred against the frozen W (``nmf.h_infer``), which the synthesis
    kernel does not model, so the JAX package leaves both of its fused
    kernels for its XLA tail there, and so does the port on either device:
    the argmax-TDOA from ``masks.argmax_tdoa`` on the fp32 fold, the
    coefficient mask from ``masks.soft_tdoa_coefficient_mask`` (which takes
    ``0**β`` literally, where the soft-mask kernel pins distance 0 to a
    mask of 1), then the H inference, the H-aware Wiener mask and the ISTFT
    as torch ops, as they are XLA ops in JAX.
    """

    def __init__(
        self,
        w: np.ndarray,
        config: OfflineConfig = OfflineConfig(mic_separation_m=0.1, num_tdoas=64),
        target_epsilon: float = 5.0,
        target_beta: float = 2.0,
        noise_floor: float = 0.0,
        num_h_updates: int = 0,
        device=None,
    ):
        self.config = config
        self.device = resolve_device(device)
        set_fp32_precision()
        self.target_epsilon = target_epsilon
        self.target_beta = target_beta
        self.noise_floor = noise_floor
        self.num_h_updates = num_h_updates
        self._stft_method = config.resolved_stft_method()
        self._synthesis_backend = config.resolved_synthesis_backend(self.device)
        self._frontend_backend = config.resolved_frontend_backend(self.device)
        window = hann_symmetric(config.window_size)
        cos_m, sin_m = gcc.steering_cos_sin(
            float(config.sample_rate), config.num_freq,
            config.mic_separation_m, config.num_tdoas,
        )
        state = from_numpy_state({"w": np.asarray(w, np.float32), "window": window,
                                  "cos": cos_m, "sin": sin_m}, self.device)
        self.w, self._window = state["w"], state["window"]
        self._cos, self._sin = state["cos"], state["sin"]
        if self._frontend_backend == "cuda":
            self._dft_basis = frontend_basis(window, conjugate=True, device=self.device,
                                             matmul_dtype=gemm_dtype(config),
                                             steering=(self._cos, self._sin))
        if self._synthesis_backend == "cuda" and num_h_updates <= 0:
            self._mask_basis = soft_mask_basis(self._cos, self._sin, self.w, gemm_dtype(config))
            self._tf_basis = tf_synthesis_basis(self.w, window, stft_gain(config),
                                                gemm_dtype(config), device=self.device)
        else:  # the folded operands depend only on constants: built once
            self._cos_w, self._sin_w = masks.fold_steering_dictionary(
                self._cos, self._sin, self.w)

    def _analyze(self, stereo):
        """``(spec planes, coherence planes, angular)`` for (B, 2, n): the
        front-end kernel's planes as stored (fp32 or bf16), or the real and
        imaginary parts of the plain path's complex spectra."""
        cfg = self.config
        if self._frontend_backend == "cuda":
            sre, sim, _, cre, cim, ang = stft_gcc_frontend_cuda(
                stereo, self._dft_basis, self._cos, self._sin, hop_size=cfg.hop_size,
                matmul_dtype=gemm_dtype(cfg), plane_dtype=plane_dtype(cfg),
            )
            return (sre, sim), (cre, cim), ang
        spec = stft_ops.stft(
            stereo, self._window, cfg.hop_size, conjugate=True, method=self._stft_method
        )  # (B, 2, T, F)
        coh = gcc.coherence(spec)
        ang = gcc.angular_spectrogram(coh, self._cos, self._sin)  # (B, T, D)
        return (spec.real, spec.imag), (coh.real, coh.imag), ang

    def _enhance_batch(self, stereo):
        """(B, 2, n) → ``(enhanced (B, 2, n_out), target index (B,),
        angular (B, T, D))``."""
        cfg = self.config
        spec, coh, ang = self._analyze(stereo)
        target_idx = torch.argmax(gcc.mean_angular_spectrum(ang), dim=-1)
        eps, beta, floor = self.target_epsilon, self.target_beta, self.noise_floor
        if self._synthesis_backend == "cuda" and self.num_h_updates <= 0:
            h_mask = soft_mask_cuda(*coh, self._mask_basis, target_idx, eps, beta, floor,
                                    matmul_dtype=gemm_dtype(cfg))
            out = tf_synthesis_cuda(*spec, h_mask, self._tf_basis, hop_size=cfg.hop_size,
                                    matmul_dtype=gemm_dtype(cfg))
            return out, target_idx, ang
        # JAX's XLA tail (offline.py _enhance_jit_impl), the H-update path on
        # either device: the argmax in fp32 on the planes as stored (bf16 in
        # the bf16 modes), the literal soft mask
        f = cfg.num_freq
        argmax_d = masks.argmax_tdoa(coh[0][..., :f], coh[1][..., :f], self._cos_w,
                                     self._sin_w, cfg.num_tdoas)  # (B, T, K)
        h_mask = masks.soft_tdoa_coefficient_mask(
            argmax_d, target_idx.to(torch.float32)[:, None, None], eps, beta, floor)
        cspec = torch.complex(spec[0][..., :f].float(), spec[1][..., :f].float())
        if self.num_h_updates > 0:
            v = cspec.abs().mean(dim=-3)  # (B, T, F), channel average
            h0 = torch.ones((*v.shape[:-1], self.w.shape[1]), device=v.device)
            h = h_infer(v, self.w, h0, self.num_h_updates, epsilon=cfg.epsilon)
            tf_mask = masks.wiener_tf_mask_h(self.w, h, h_mask, cfg.epsilon)
        else:
            tf_mask = masks.wiener_tf_mask(self.w, h_mask)  # (B, T, F)
        out = stft_ops.istft(
            tf_mask[:, None] * cspec, self._window, cfg.hop_size, conjugate=True,
            center_trim=True, method=self._stft_method,
        )
        return out * stft_gain(cfg), target_idx, ang

    @torch.inference_mode()
    def enhance(self, stereo: np.ndarray):
        """Enhance a (2, n) or (B, 2, n) mixture → dict of ``enhanced``
        (same rank as the input), ``target_tdoa_index`` (a scalar or (B,))
        and ``angular`` ((T, D) or (B, T, D)), as NumPy."""
        x = torch.as_tensor(np.asarray(stereo, np.float32), device=self.device)
        single = x.ndim == 2
        out, target_idx, ang = self._enhance_batch(x[None] if single else x)
        if single:
            out, target_idx, ang = out[0], target_idx[0], ang[0]
        return dict(
            enhanced=out.cpu().numpy(),
            target_tdoa_index=target_idx.to(torch.int32).cpu().numpy(),
            angular=ang.cpu().numpy(),
        )
