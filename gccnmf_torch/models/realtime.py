"""Streaming RT-GCC-NMF: fixed-latency block processing (counterpart of
``gccnmf_tpu/models/realtime.py``).

The reference runs real-time GCC-NMF as three OS processes exchanging
512-sample blocks through shared memory (reference:
gccNMF/realtime/{runRealtimeGCCNMF,audioProcessor,gccNMFProcessor,utils}.py).
Here one function carries the overlap-add rings, the GCC-PHAT localization
history and the target index as explicit state:

    eager_step : (StreamState, block, StreamParams) → (StreamState, out, telemetry)

Every state leaf leads with a stream-batch axis B, so B independent streams
are enhanced in lockstep. The eager step is plain torch ops, the ones the JAX
package leaves to XLA; it is what runs on the CPU. On a CUDA device
:meth:`RTGCCNMFProcessor.step` replays one captured CUDA graph of that step
per block (:class:`CapturedStep`): static state, input, parameter and output
tensors, the state written back in place. Parameters are runtime tensor
values, copied into the graph's own, so changing one never re-captures
anything (JAX's traced scalars; the reference's Theano shared variables,
gccNMFProcessor.py:195-199).

Batch invariance: a stream gives what it gives alone whatever else shares
its batch. Three results feed an argmax, where a difference in the last bit
can flip the winner: the spectrum, the folded score GEMM and the angular
spectrogram (per-atom TDOA), and the windowed GCC-PHAT mean (localization).
The first two run over fixed chunks of ``ROWS`` zero-padded rows, so every
FFT and GEMM call has the same shape at any B and each row's sums run in
one order; the mean is summed in float64.

Latency: a block is emitted as soon as it is overlap-add-complete,
``(synthesis_support - hop) + block`` samples of algorithmic delay; the
reference's fixed 2-block emission (utils.py:116) is
``extra_delay_blocks=1``.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from gccnmf_torch.device import resolve_device
from gccnmf_torch.ops import gcc, masks, nmf, stft as stft_ops
from gccnmf_torch.ops import windows as win_ops
from gccnmf_torch.precision import set_fp32_precision

__all__ = [
    "StreamConfig", "StreamParams", "StreamState", "RTGCCNMFProcessor", "CapturedStep",
    "parse_target_mode", "reset_slot",
]

TARGET_MODE_BOXCAR = 0
TARGET_MODE_WINDOW_FUNCTION = 2

# rows of every FFT and GEMM call whose result feeds an argmax (see the
# module docstring); 64 is the 64 streams of one default server tick
ROWS = 64
# graph warm-up steps on the capture stream: cuFFT plans and cuBLAS
# workspaces must exist before capture
WARMUP_STEPS = 3

# one side stream per device for every warm-up and capture, one capture at a
# time: cuBLAS keeps a workspace per stream (32 MiB on an H100), so a fresh
# stream for each capture held one more workspace for every rebuild
_CAPTURE_STREAMS: dict = {}
_CAPTURE_LOCK = threading.Lock()


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def parse_target_mode(value) -> int:
    """Normalize a target-mode spec: "window"/"boxcar" names or the
    reference's integer constants (gccNMFProcessor.py:35-37).
    TARGET_MODE_MULTIPLE (1) is a documented non-port (PARITY.md)."""
    key = str(value).strip().lower()
    modes = {
        "boxcar": TARGET_MODE_BOXCAR,
        str(TARGET_MODE_BOXCAR): TARGET_MODE_BOXCAR,
        "window": TARGET_MODE_WINDOW_FUNCTION,
        "window_function": TARGET_MODE_WINDOW_FUNCTION,
        str(TARGET_MODE_WINDOW_FUNCTION): TARGET_MODE_WINDOW_FUNCTION,
    }
    if key in ("1", "multiple"):
        raise ValueError(
            "TARGET_MODE_MULTIPLE is not supported (documented non-port, "
            "see PARITY.md); use 'window' or 'boxcar'"
        )
    if key not in modes:
        raise ValueError(f"unknown target mode: {value!r}")
    return modes[key]


@dataclass(frozen=True)
class StreamConfig:
    """Streaming parameters (defaults match reference realtime/config.py:46-73)."""

    sample_rate: int = 16000
    window_size: int = 1024
    hop_size: int = 512
    block_size: int = 512
    num_tdoas: int = 64
    mic_separation_m: float = 0.1
    num_channels: int = 2
    history_length: int = 128
    target_mode: int = TARGET_MODE_WINDOW_FUNCTION
    extra_delay_blocks: int = 0
    analysis_window: str = "sqrt_hamming"  # or "asymmetric"
    synthesis_length: int = 256  # only for asymmetric windows
    # per-block H inference steps against the frozen dictionary; 0 = the
    # reference's W-only realtime rule (it plumbs numHUpdates but never
    # infers H, gccNMFProcessor.py:195 vs :201-231). N > 0 runs N
    # multiplicative H updates and applies the H-aware Wiener mask.
    # Structural: it changes the step, so a new processor captures anew.
    num_h_updates: int = 0
    # numerical floor shared with the offline enhancer's H-aware Wiener mask
    epsilon: float = 1e-16

    @classmethod
    def from_app_config(cls, cfg, **overrides) -> "StreamConfig":
        """Map a :class:`gccnmf_torch.config.GCCNMFConfig` (duck-typed) to the
        streaming engine's config: the one mapping the ``stream`` and
        ``serve`` commands share."""
        fields = dict(
            sample_rate=cfg.sample_rate,
            window_size=cfg.window_size,
            hop_size=cfg.hop_size,
            block_size=cfg.block_size,
            num_tdoas=cfg.num_tdoas,
            mic_separation_m=cfg.microphone_separation_in_metres,
            num_channels=cfg.num_channels,
            history_length=cfg.num_tdoa_history,
            target_mode=parse_target_mode(getattr(cfg, "target_mode", "window")),
            num_h_updates=getattr(cfg, "num_h_updates", 0),
            epsilon=getattr(cfg, "epsilon", 1e-16),
        )
        fields.update(overrides)
        return cls(**fields)

    @property
    def windows_per_block(self) -> int:
        return self.block_size // self.hop_size

    @property
    def num_freq(self) -> int:
        return self.window_size // 2 + 1

    @property
    def ola_length(self) -> int:
        return self.window_size + (self.windows_per_block - 1) * self.hop_size

    @property
    def synthesis_support(self) -> int:
        """Length of the synthesis window's nonzero tail."""
        return (
            self.synthesis_length
            if self.analysis_window == "asymmetric"
            else self.window_size
        )

    @property
    def emit_lag(self) -> int:
        """Content delay in samples between input and emitted output: a
        sample is complete once the last synthesis-window support covering
        it has been overlap-added, ``synthesis_support - hop`` samples after
        it arrives (``window - hop`` for symmetric windows,
        ``synthesis_length - hop`` for the asymmetric low-latency pair)."""
        return self.synthesis_support - self.hop_size

    @property
    def algorithmic_latency_s(self) -> float:
        """Worst-case input-to-output delay in seconds."""
        samples = self.emit_lag + self.block_size * (1 + self.extra_delay_blocks)
        return samples / self.sample_rate


class StreamParams(NamedTuple):
    """Control parameters as tensors: change them freely, nothing is
    re-captured. Each leaf is a scalar or batched over streams: ``(B,)``
    for the first, sixth and seventh, ``(B, 1, 1)`` for the others."""

    target_tdoa_index: torch.Tensor  # float32; used when localization is off
    target_epsilon: torch.Tensor  # generalized-Gaussian width
    target_beta: torch.Tensor  # shape
    noise_floor: torch.Tensor
    separation_enabled: torch.Tensor  # bool
    localization_enabled: torch.Tensor  # bool
    localization_window: torch.Tensor  # int32 frames of history to average

    @staticmethod
    def default(
        target_tdoa_index=32.0,
        target_epsilon=5.0,
        target_beta=2.0,
        noise_floor=0.0,
        separation_enabled=True,
        localization_enabled=True,
        localization_window=6,
        device=None,
    ) -> "StreamParams":
        dev = resolve_device(device)

        def t(x, dtype):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        return StreamParams(
            t(target_tdoa_index, torch.float32),
            t(target_epsilon, torch.float32),
            t(target_beta, torch.float32),
            t(noise_floor, torch.float32),
            t(separation_enabled, torch.bool),
            t(localization_enabled, torch.bool),
            t(localization_window, torch.int32),
        )


class StreamState(NamedTuple):
    carry_in: torch.Tensor  # (B, C, window - hop) trailing input samples
    ola_acc: torch.Tensor  # (B, C, ola_length) output overlap-add accumulator
    gcc_history: torch.Tensor  # (B, hist_len, D) ring of freq-avg GCC-PHAT
    hist_count: torch.Tensor  # (B,) int32 frames written so far
    target_idx: torch.Tensor  # (B,) float32 current (localized) target TDOA
    delay_buf: torch.Tensor  # (B, C, extra_delay_blocks, block) FIFO


def _by_row_chunks(fn, *planes):
    """``fn`` over the rows of ``planes`` (..., X), zero-padded to a multiple
    of :data:`ROWS` and cut into chunks of ROWS rows: every call has one
    shape at any batch, so a row's result does not depend on the others.
    ``fn`` returns a tuple of (ROWS, ...) tensors; so does this, with the
    leading dimensions of ``planes`` restored."""
    lead = planes[0].shape[:-1]
    n = math.prod(lead)
    pad = -n % ROWS
    flat = [torch.nn.functional.pad(p.reshape(n, p.shape[-1]), (0, 0, 0, pad)) for p in planes]
    parts = [fn(*(p[i:i + ROWS] for p in flat)) for i in range(0, n + pad, ROWS)]
    return tuple(torch.cat(col)[:n].reshape(*lead, *col[0].shape[1:]) for col in zip(*parts))


def reset_slot(state: StreamState, fresh: StreamState, slot) -> None:
    """Write ``fresh`` (a batch-1 state) into row ``slot`` of every leaf of
    ``state``, in place (``slot=None``: every row)."""
    for leaf, new in zip(state, fresh):
        if slot is None:
            leaf.copy_(new.expand_as(leaf))
        else:
            leaf[slot].copy_(new[0])


class RTGCCNMFProcessor:
    """The streaming enhancement engine around a pre-learned dictionary W.

    ``device=None`` runs on the card (and raises without one); tests pass
    ``device="cpu"``, where :meth:`step` is the eager step."""

    def __init__(self, w, config: StreamConfig = StreamConfig(), device=None):
        cfg = config
        if cfg.block_size % cfg.hop_size:
            raise ValueError("hop_size must divide block_size")
        self.config = cfg
        self.device = dev = resolve_device(device)
        set_fp32_precision()
        self.w = torch.as_tensor(np.asarray(w, np.float32), device=dev)  # (F, K)
        if self.w.shape[0] != cfg.num_freq:
            raise ValueError(
                f"dictionary has {self.w.shape[0]} rows, config expects {cfg.num_freq}"
            )
        if cfg.analysis_window == "sqrt_hamming":
            # the reference's RT windows: sqrt(hamming) analysis and
            # synthesis (gccNMFProcessor.py:186-187)
            wa = ws = win_ops.sqrt_hamming(cfg.window_size)
        elif cfg.analysis_window == "asymmetric":
            wa, ws = win_ops.asymmetric_analysis_synthesis_pair(
                cfg.window_size, cfg.synthesis_length, cfg.hop_size
            )
        else:
            raise ValueError(f"unknown analysis_window: {cfg.analysis_window}")
        self._analysis_window = torch.as_tensor(wa, device=dev)
        self._synthesis_window = torch.as_tensor(ws, device=dev)
        self._cos_sin = tuple(torch.as_tensor(m, device=dev) for m in gcc.steering_cos_sin(
            float(cfg.sample_rate), cfg.num_freq, cfg.mic_separation_m, cfg.num_tdoas))
        # steering ⊗ dictionary folded for the flat attribution GEMM
        self._cos_w, self._sin_w = masks.fold_steering_dictionary(*self._cos_sin, self.w)
        self._graphs: dict[int, CapturedStep] = {}

    # ------------------------------------------------------------------ state

    def init_state(self, batch_size: int = 1) -> StreamState:
        cfg = self.config
        b, c = batch_size, cfg.num_channels

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return StreamState(
            carry_in=zeros(b, c, cfg.window_size - cfg.hop_size),
            ola_acc=zeros(b, c, cfg.ola_length),
            gcc_history=zeros(b, cfg.history_length, cfg.num_tdoas),
            hist_count=zeros(b, dtype=torch.int32),
            target_idx=torch.full((b,), cfg.num_tdoas / 2.0, dtype=torch.float32,
                                  device=self.device),
            delay_buf=zeros(b, c, cfg.extra_delay_blocks, cfg.block_size),
        )

    # ------------------------------------------------------------------- step

    def eager_step(self, state: StreamState, block: torch.Tensor, params: StreamParams):
        """Process one (B, C, block_size) input block with torch ops; the
        operations and their order are JAX's ``_step_impl``. Returns
        ``(new_state, out_block, telemetry)`` without touching ``state``."""
        cfg = self.config
        m = cfg.windows_per_block

        # --- input OLA framing: last window+(m-1)hop samples, m windows ----
        stacked = torch.cat([state.carry_in, block], dim=-1)
        frames = stft_ops.frame_signal(stacked, cfg.window_size, cfg.hop_size)
        # frames: (B, C, m, window) → spec (B, C, m, F)
        (spec,) = _by_row_chunks(
            lambda x: (torch.fft.rfft(x, n=cfg.window_size, dim=-1),),
            frames * self._analysis_window,
        )
        spec = spec.to(torch.complex64)

        # guard_zeros: an all-zero block (idle serving slot, digital
        # silence) must not write NaN into the localization history
        coh = gcc.coherence(spec, guard_zeros=True)  # (B, m, F)
        # attribution over all TDOAs (the fold GEMM + argmax) and the
        # angular spectrogram, both on chunks of ROWS rows
        argmax_d, ang = _by_row_chunks(
            lambda re, im: (
                masks.argmax_tdoa(re, im, self._cos_w, self._sin_w, cfg.num_tdoas),
                gcc.angular_spectrogram(torch.complex(re, im), *self._cos_sin),
            ),
            coh.real, coh.imag,
        )  # (B, m, K), (B, m, D)

        target = state.target_idx[:, None, None]  # the mask uses the pre-update target
        if cfg.target_mode == TARGET_MODE_BOXCAR:
            h_mask = masks.boxcar_tdoa_coefficient_mask(argmax_d, target, params.target_epsilon)
        else:
            h_mask = masks.soft_tdoa_coefficient_mask(
                argmax_d, target, params.target_epsilon, params.target_beta,
                params.noise_floor,
            )
        if cfg.num_h_updates > 0:
            # block-local coefficients against the frozen W weight the mask
            # (the formula the offline enhancer shares)
            v = torch.mean(spec.abs(), dim=1)  # (B, m, F) channel-average magnitudes
            h0 = torch.ones(v.shape[:-1] + (self.w.shape[1],), dtype=torch.float32,
                            device=v.device)
            h = nmf.h_infer(v, self.w, h0, cfg.num_h_updates, epsilon=cfg.epsilon)
            tf_mask = masks.wiener_tf_mask_h(self.w, h, h_mask, epsilon=cfg.epsilon)
        else:
            tf_mask = masks.wiener_tf_mask(self.w, h_mask)  # (B, m, F)
        tf_mask = torch.where(params.separation_enabled, tf_mask, 1.0)
        out_spec = tf_mask[:, None, :, :] * spec  # (B, C, m, F)

        out_frames = torch.fft.irfft(out_spec, n=cfg.window_size, dim=-1) * self._synthesis_window
        ola = stft_ops.overlap_add(out_frames, cfg.hop_size)  # (B, C, ola_len)
        acc = state.ola_acc
        shifted = torch.cat(
            [acc[..., cfg.block_size:], torch.zeros_like(acc[..., : cfg.block_size])], dim=-1
        )
        acc = shifted + ola
        # emit the newest fully-summed block (see StreamConfig.emit_lag)
        emit_start = cfg.ola_length - cfg.block_size - cfg.emit_lag
        complete = acc[..., emit_start: emit_start + cfg.block_size]

        # --- extra delay FIFO (the reference's 2-block emission) ----------
        if cfg.extra_delay_blocks:
            out_block = state.delay_buf[..., 0, :]
            delay_buf = torch.cat([state.delay_buf[..., 1:, :], complete[..., None, :]], dim=-2)
        else:
            out_block = complete
            delay_buf = state.delay_buf

        # --- GCC-PHAT history + localization, after masking as in the
        # reference (gccNMFProcessor.py:216-227): freq-avg GCC-PHAT per
        # frame is the angular spectrogram / F
        ang = ang / cfg.num_freq
        history = torch.cat([state.gcc_history[:, m:], ang], dim=1)
        hist_count = torch.clamp(state.hist_count + m, max=cfg.history_length)

        # masked mean over the last `localization_window` valid frames, in
        # float64 so that its argmax does not depend on the batch's
        # reduction order (JAX: a float32 einsum)
        lw = torch.minimum(params.localization_window, hist_count)  # (B,)
        pos = torch.arange(cfg.history_length, device=lw.device)
        sel = (pos[None, :] >= cfg.history_length - lw[:, None]).to(torch.float64)
        mean_gcc = (history.to(torch.float64) * sel[..., None]).sum(dim=1) / torch.clamp(
            lw[:, None], min=1).to(torch.float64)
        localized = torch.argmax(mean_gcc, dim=-1).to(torch.float32)
        target_idx = torch.where(params.localization_enabled, localized,
                                 params.target_tdoa_index)

        new_state = StreamState(
            carry_in=stacked[..., cfg.block_size:],
            ola_acc=acc,
            gcc_history=history,
            hist_count=hist_count,
            target_idx=target_idx,
            delay_buf=delay_buf,
        )
        telemetry = dict(
            target_tdoa_index=target_idx,
            gcc_phat=ang,
            coefficient_mask=h_mask,
            input_mag=torch.mean(spec.abs(), dim=1),  # (B, m, F)
            output_mag=torch.mean(out_spec.abs(), dim=1),
        )
        return new_state, out_block, telemetry

    def captured(self, batch_size: int) -> "CapturedStep":
        """The CUDA graph of one step at ``batch_size`` (captured at first use)."""
        if self.device.type != "cuda":
            raise RuntimeError(f"a captured step needs a CUDA device, not {self.device}")
        if batch_size not in self._graphs:
            self._graphs[batch_size] = CapturedStep(self, batch_size)
        return self._graphs[batch_size]

    def step(self, state: StreamState, block, params: StreamParams):
        """One (B, C, block_size) block → ``(state, out_block, telemetry)``.

        On the CPU this is :meth:`eager_step`. On CUDA it replays the
        captured graph at batch B: the returned state, output and telemetry
        are the graph's own tensors, which the next step at that batch
        overwrites in place (copy what must outlive it). Passing back the
        returned state costs nothing; another state is copied in first."""
        if self.device.type != "cuda":
            return self.eager_step(state, torch.as_tensor(block, device=self.device), params)
        g = self.captured(block.shape[0])
        g.load(state, block, params)
        g.graph.replay()
        return g.state, g.out, g.telemetry

    # ------------------------------------------------------------- scan mode

    def scan_blocks(self, state: StreamState, blocks, params: StreamParams,
                    with_telemetry: bool = False):
        """Process (num_blocks, B, C, block_size) blocks in order; returns
        ``(state, outs)``, or ``(state, (outs, telemetry))`` with every
        telemetry entry stacked over blocks. On CUDA the loop does nothing
        between blocks but write the block into the graph, replay it and
        copy its output out, all enqueued without waiting for the card."""
        blocks = torch.as_tensor(blocks, device=self.device)
        outs, tels = [], []
        if self.device.type != "cuda":
            for blk in blocks:
                state, out, tel = self.eager_step(state, blk, params)
                outs.append(out)
                tels.append(tel)
            outs = torch.stack(outs)
            tel = {k: torch.stack([t[k] for t in tels]) for k in tels[0]} if tels else {}
            return state, ((outs, tel) if with_telemetry else outs)
        g = self.captured(blocks.shape[1])
        g.load(state, blocks[0], params)
        outs = torch.empty((blocks.shape[0],) + tuple(g.out.shape), device=self.device)
        tel = {k: torch.empty((blocks.shape[0],) + tuple(v.shape), dtype=v.dtype,
                              device=self.device)
               for k, v in g.telemetry.items()} if with_telemetry else {}
        for i in range(blocks.shape[0]):
            g.block.copy_(blocks[i])
            g.graph.replay()
            outs[i].copy_(g.out)
            for k, v in tel.items():
                v[i].copy_(g.telemetry[k])
        return g.state, ((outs, tel) if with_telemetry else outs)

    # ------------------------------------------------------------ host modes

    def blocks_from_signal(self, stereo: np.ndarray) -> np.ndarray:
        """Split (C, n) or (B, C, n) audio into (num_blocks, B, C, block)."""
        cfg = self.config
        if stereo.ndim == 2:
            stereo = stereo[None]
        b, c, n = stereo.shape
        nb = n // cfg.block_size
        trimmed = stereo[..., : nb * cfg.block_size]
        return np.moveaxis(trimmed.reshape(b, c, nb, cfg.block_size), 2, 0)

    def enhance_signal(self, stereo: np.ndarray, params: StreamParams | None = None) -> np.ndarray:
        """Stream a whole signal through :meth:`scan_blocks`; returns
        (B, C, n_out) NumPy float32 aligned like the realtime output (the
        leading algorithmic delay kept)."""
        params = params or StreamParams.default(device=self.device)
        blocks = np.ascontiguousarray(self.blocks_from_signal(np.asarray(stereo, np.float32)))
        state = self.init_state(blocks.shape[1])
        _, outs = self.scan_blocks(state, blocks, params)
        out = outs.movedim(0, 2).cpu().numpy()  # (B, C, nb, block)
        b, c, nb, blk = out.shape
        return out.reshape(b, c, nb * blk)


class CapturedStep:
    """One :meth:`RTGCCNMFProcessor.eager_step` at one batch size, captured
    as a CUDA graph and replayed per block.

    Static tensors: ``state`` (written back in place at the end of every
    replay), ``block`` (the input, which the caller writes before a replay),
    ``params`` (at the batched shapes, copied in by :meth:`set_params`) and
    the outputs ``out`` and ``telemetry``, which every replay overwrites.
    ``wire_in`` / ``wire_out`` convert the input and the output inside the
    graph (the server's int16 wire). A failed capture or replay raises: there
    is no eager fallback on the card.

    The capture runs in ``thread_local`` mode: a CUDA call that another
    thread makes meanwhile (a realtime app's GUI thread, a server's fetch
    thread) neither joins nor invalidates it. Every capture on a device
    warms up and captures on one side stream, one capture at a time, so
    rebuilding a processor reuses that stream's cuBLAS workspace instead of
    allocating another. Once captured, the step keeps no reference to its
    processor, so dropping the processor frees its graphs at once instead
    of at the next cyclic garbage collection."""

    def __init__(self, proc: RTGCCNMFProcessor, batch: int, block_dtype=torch.float32,
                 wire_in=None, wire_out=None):
        cfg, dev = proc.config, proc.device
        self._proc, self._wire_in, self._wire_out = proc, wire_in, wire_out
        self.state = proc.init_state(batch)
        self._fresh = proc.init_state(1)
        self.block = torch.zeros((batch, cfg.num_channels, cfg.block_size), dtype=block_dtype,
                                 device=dev)
        shapes = ((batch,), (batch, 1, 1), (batch, 1, 1), (batch, 1, 1), (batch, 1, 1),
                  (batch,), (batch,))
        self.params = StreamParams(*(p.expand(s).clone() for p, s in zip(
            StreamParams.default(device=dev), shapes)))
        self._params_src = None
        set_fp32_precision()
        with _CAPTURE_LOCK:
            stream = _capture_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_STEPS):
                    self._run()
            torch.cuda.current_stream(dev).wait_stream(stream)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
                self.out, self.telemetry = self._run()
        self._proc = None
        self.reset()  # the warm-up advanced the state

    def _run(self):
        x = self.block if self._wire_in is None else self._wire_in(self.block)
        new, out, tel = self._proc.eager_step(self.state, x, self.params)
        # the output may view the state (the delay FIFO's head): take it
        # before the write-back
        out = (out.clone(memory_format=torch.contiguous_format) if self._wire_out is None
               else self._wire_out(out))
        for leaf, value in zip(self.state, new):
            if value is not leaf:
                leaf.copy_(value)
        return out, tel

    def reset(self, slot=None) -> None:
        """A fresh state in row ``slot`` (``None``: every row), in place."""
        reset_slot(self.state, self._fresh, slot)

    def set_params(self, params: StreamParams) -> None:
        """Copy ``params`` (scalars, or batched as the fields say; on the
        card or the host) into the graph's parameter tensors, without
        waiting for the card."""
        for dst, src in zip(self.params, params):
            src = torch.as_tensor(src)
            dst.copy_(src.reshape(dst.shape) if src.dim() else src, non_blocking=True)

    def load(self, state: StreamState, block, params: StreamParams) -> None:
        """Write a step's inputs into the graph: ``block`` always, ``state``
        unless it is the graph's own, ``params`` when it is another object
        than the last one loaded. Host inputs are copied without waiting
        for the card (a pinned ``block`` must not be rewritten before the
        step's work is done)."""
        if state is not self.state:
            for dst, src in zip(self.state, state):
                dst.copy_(src)
        self.block.copy_(torch.as_tensor(block), non_blocking=True)
        if params is not self._params_src:
            self.set_params(params)
            self._params_src = params
