"""Headless realtime GCC-NMF application shell (counterpart of
``gccnmf_tpu/realtime/app.py``).

The reference's app (reference: gccNMF/realtime/runRealtimeGCCNMF.py:41-190)
spawns three OS processes — Qt GUI, PyAudio I/O, DSP — wired with
Queue+Event handshakes and shared-memory arrays. Here it is one host
process:

- the audio layer is an iterator (:class:`FilePlayerSource`);
- the DSP is :class:`gccnmf_torch.models.realtime.RTGCCNMFProcessor`: on
  the card one captured CUDA graph of the step, replayed per block, whose
  state stays on the card; on the CPU the eager step;
- control parameters (``StreamParams``) live on the host: a setter
  replaces them there, and the audio thread copies them into the graph's
  own tensors before the next replay, so a slider never re-captures
  anything (the reference's Theano SharedVariable fast path,
  gccNMFProcessor.py:106-125);
- structural changes (dictionary size/type, TDOA grid, geometry, mask
  rule) build a new processor, whose graph the audio thread captures at the
  next block (the reference's reset()/buildTheanoFunctions slow path,
  gccNMFProcessor.py:127-157, 233-270);
- telemetry histories are host ring buffers (:class:`CircularBuffer`). The
  captured step overwrites its output and telemetry tensors at every
  replay, so each block's output and telemetry are copied out into buffers
  of their own (pinned host memory, without waiting for the card) and read
  only after the CUDA event recorded behind the copy;
- per-block wall times are logged every 2 s like the reference's audio
  process (audioProcessor.py:98-102).

Threads: one audio thread calls :meth:`RealtimeGCCNMF.process_block` (and
:meth:`~RealtimeGCCNMF.run`); other threads (a GUI, a control surface) call
the setters, read ``histories``, ``params``, ``config`` and
:meth:`~RealtimeGCCNMF.peek_dictionary`. Every path that touches the card
runs under the engine lock, so nothing else reaches the card while the
audio thread captures a new graph; ``params`` and the dictionary a reader
sees are host values.

No GUI here: this is the ``RealtimeGCCNMFNoGUI`` equivalent
(runRealtimeGCCNMF.py:122-179) and the programmatic host for notebooks and
benchmarks; the window is :mod:`gccnmf_torch.gui`.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import replace as dc_replace

import numpy as np
import torch

from gccnmf_torch import native, pretrain
from gccnmf_torch.config import GCCNMFConfig, load_config
from gccnmf_torch.device import resolve_device
from gccnmf_torch.models.realtime import (
    RTGCCNMFProcessor,
    StreamConfig,
    StreamParams,
    parse_target_mode,
)
from gccnmf_torch.realtime.audio import FilePlayerSource, StreamingSink, WavSink
from gccnmf_torch.realtime.buffers import CircularBuffer
from gccnmf_torch.utils.hostmem import HostMemWatchdog, PeriodicTrim

logger = logging.getLogger(__name__)

__all__ = ["RealtimeGCCNMF"]

_TELEMETRY_LOG_INTERVAL_S = 2.0

# the step's telemetry outputs that the histories read
_TELEMETRY_KEYS = ("target_tdoa_index", "gcc_phat", "coefficient_mask", "input_mag",
                   "output_mag")


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


class _HostSlot:
    """One block's input and output in pinned host memory, and the event
    recorded behind the output's copy. The input is read by the card and
    the output written by it without the host waiting, so a slot is
    rewritten only after :meth:`fetch` returned."""

    def __init__(self, shape):
        self.host_in = torch.empty(shape, pin_memory=True)
        self.host_out = torch.empty(shape, pin_memory=True)
        self.event = torch.cuda.Event()

    def fetch(self) -> np.ndarray:
        self.event.synchronize()
        return self.host_out.numpy()[0].copy()


class _TelemetryRing:
    """The telemetry of the last ``capacity`` blocks not yet drained, each
    block in rows of its own (the step's telemetry tensors are overwritten
    by the next replay). On the card the rows are pinned host memory,
    written without waiting for the card, and a drain waits on the event
    recorded behind the newest block's copies. Bounded like the JAX app's
    queue: a drain after more than ``capacity`` blocks sees the newest
    ``capacity``."""

    def __init__(self, telemetry: dict, capacity: int):
        cuda = telemetry["gcc_phat"].is_cuda
        self.shapes = {k: tuple(telemetry[k].shape) for k in _TELEMETRY_KEYS}
        self.rows = {k: torch.empty((capacity, *self.shapes[k]), dtype=telemetry[k].dtype,
                                    pin_memory=cuda) for k in _TELEMETRY_KEYS}
        self.event = torch.cuda.Event() if cuda else None
        self.capacity = capacity
        self.next = 0
        self.pending = 0

    def matches(self, telemetry: dict) -> bool:
        return all(tuple(telemetry[k].shape) == self.shapes[k] for k in _TELEMETRY_KEYS)

    def push(self, telemetry: dict) -> None:
        for k, rows in self.rows.items():
            rows[self.next].copy_(telemetry[k], non_blocking=True)
        if self.event is not None:
            self.event.record()
        self.next = (self.next + 1) % self.capacity
        self.pending = min(self.pending + 1, self.capacity)

    def drain(self) -> dict | None:
        """The pending blocks, oldest first, as NumPy ``(n, ...)`` arrays."""
        if not self.pending:
            return None
        if self.event is not None:
            self.event.synchronize()
        idx = (self.next - self.pending + np.arange(self.pending)) % self.capacity
        self.pending = 0
        return {k: rows.numpy()[idx] for k, rows in self.rows.items()}

    def clear(self) -> None:
        self.pending = 0


class RealtimeGCCNMF:
    """Single-process realtime GCC-NMF speech enhancer over a WAV source."""

    def __init__(
        self,
        audio_path: str | None = None,
        config_path: str | None = None,
        config: GCCNMFConfig | None = None,
        dictionaries: dict | None = None,
        pipeline_depth: int = 0,
        device=None,
    ):
        """``pipeline_depth``: number of blocks the output is allowed to lag
        dispatch. 0 (default) waits for each block's output before the
        next dispatch — one full host↔device round trip on the deadline
        path per block. N>0 dispatches block n, starts its device→host copy
        without waiting, and returns block n−N's (already-copied) output —
        the round trip leaves the deadline path at the price of N blocks of
        extra latency (N·32 ms at the reference geometry). The reference
        pays a comparable price with its fixed 2-block OLA emission delay
        (utils.py:116) plus the Event-handshake round trip
        (audioProcessor.py:118-122).

        ``device=None`` runs on the card (and raises without one); pass
        ``device="cpu"`` for the CPU."""
        self.device = resolve_device(device)
        self.config = config or load_config(config_path, audio_path=audio_path)
        cfg = self.config
        self.audio_path = audio_path or cfg.audio_path
        if self.audio_path is None:
            from gccnmf_torch import defs

            self.audio_path = defs.DEFAULT_AUDIO_FILE
        self._dictionaries = dictionaries  # {type: {size: W}} or None (lazy)
        self.dictionary_size = cfg.dictionary_size
        self.dictionary_type = cfg.dictionary_type
        # host tensors: readers (a GUI) take np.asarray of them; the audio
        # thread copies them into the captured graph when they change
        self.params = StreamParams.default(
            target_epsilon=cfg.target_tdoa_epsilon,
            target_beta=cfg.target_tdoa_beta,
            noise_floor=cfg.target_tdoa_noise_floor,
            localization_enabled=cfg.localization_enabled,
            localization_window=cfg.localization_window_size,
            target_tdoa_index=cfg.num_tdoas / 2.0,
            device="cpu",
        )
        self._processor: RTGCCNMFProcessor | None = None
        self._state = None
        self._w_host: np.ndarray | None = None  # the engine's W, for readers
        if pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        self.pipeline_depth = pipeline_depth
        self._inflight: deque = deque()  # fetch() of outputs not returned yet
        self._slots: list[_HostSlot] = []  # the engine's pinned block ring
        self._next_slot = 0
        # (old_state, keep_localization) to migrate into the next engine
        self._carry_state: tuple | None = None
        # serializes structural engine swaps (set_dictionary, called from a
        # GUI thread) against the audio thread's process_block, and keeps
        # every other touch of the card off the audio thread's captures
        self._engine_lock = threading.Lock()
        # per-block wall-time telemetry in the native tier (lock-free window
        # ring; reference logs the same min/avg/max, audioProcessor.py:98-102)
        self._block_times = native.BlockTimes(capacity=256)
        #: milliseconds of each engine build: the processor and, on the
        #: card, the capture of its graph (the JAX app re-jits there)
        self.rebuild_ms: deque = deque(maxlen=256)
        self._heap_trimmer = PeriodicTrim()
        self._last_log = time.perf_counter()

        hist = cfg.num_tdoa_history
        spec_hist = cfg.num_spectrogram_history
        # one coefficient-mask history per dictionary size, kept across size
        # switches so flipping back restores the old waterfall (the reference
        # allocates one shared buffer per size up front,
        # runRealtimeGCCNMF.py:74-81); sizes are allocated lazily here
        self._mask_histories: dict[int, CircularBuffer] = {
            cfg.dictionary_size: CircularBuffer(cfg.dictionary_size, spec_hist)
        }
        self._histories = {
            "gcc_phat": CircularBuffer(cfg.num_tdoas, hist),
            "tdoa": CircularBuffer((), hist),
            "input_spectrogram": CircularBuffer(cfg.num_freq, spec_hist),
            "output_spectrogram": CircularBuffer(cfg.num_freq, spec_hist),
            "coefficient_mask": self._mask_histories[cfg.dictionary_size],
        }
        # telemetry waits in its ring until someone reads `histories` (the
        # GUI's 100 ms timer, a notebook cell): the block loop never waits
        # for a device→host fetch of plots nobody is watching. Bounded at
        # the history depth so a late drain can still fill the rings.
        self._telemetry_capacity = max(hist, spec_hist)
        self._telemetry: _TelemetryRing | None = None

    # ----------------------------------------------------------- dictionary

    def _clear_telemetry(self) -> None:
        if self._telemetry is not None:
            self._telemetry.clear()

    def _activate_mask_history(self, size: int) -> None:
        """Point the active coefficient-mask history at ``size``'s buffer,
        allocating it on first use. Old sizes keep their waterfalls (the
        reference's per-size shared buffers, runRealtimeGCCNMF.py:74-81).
        Pending telemetry carries the *old* mask width, so it is dropped."""
        buf = self._mask_histories.setdefault(
            size, CircularBuffer(size, self.config.num_spectrogram_history)
        )
        if self._histories["coefficient_mask"] is not buf:
            self._histories["coefficient_mask"] = buf
            self._clear_telemetry()

    @property
    def mask_histories(self) -> dict:
        """Per-dictionary-size coefficient-mask rings (lazily allocated)."""
        return self._mask_histories

    def peek_dictionary(self) -> np.ndarray | None:
        """The current engine's dictionary W (a read-only host array), or
        None if no engine is built.

        Never triggers a (re)build and never touches the card — safe from
        the GUI thread while the audio thread captures a new engine's graph
        under the engine lock. The copy is taken when the engine is built."""
        return None if self._processor is None else self._w_host

    def _get_dictionary(self) -> np.ndarray:
        if self.config.dictionary_file:
            # explicit artifact (pretrain --save-dir handoff) wins over the
            # corpus-keyed pretraining cache
            w = pretrain.load_dictionary_file(
                self.config.dictionary_file, self.config.num_freq
            )
            k = w.shape[1]
            if k != self.dictionary_size:
                # the artifact's atom count is the truth: telemetry buffers
                # sized from cfg.dictionary_size would reject the engine's
                # (·, K) masks with a broadcast error otherwise
                self.dictionary_size = k
                self.config = dc_replace(self.config, dictionary_size=k)
                self._activate_mask_history(k)
            return w
        if self._dictionaries is None:
            self._dictionaries = {}
        bank = self._dictionaries.setdefault(self.dictionary_type, {})
        if self.dictionary_size not in bank:
            # fetch lazily, one size at a time — switching sizes later only
            # trains/loads what is actually used (the reference pretrains
            # every size up front, gccNMFPretraining.py:43-58)
            trained = pretrain.get_dictionaries(
                self.config.window_size, sizes=(self.dictionary_size,), device=self.device
            )
            for dict_type, sizes in trained.items():
                self._dictionaries.setdefault(dict_type, {}).update(sizes)
        return self._dictionaries[self.dictionary_type][self.dictionary_size]

    @property
    def processor(self) -> RTGCCNMFProcessor:
        """The engine, built (and on the card captured) on first use after
        a structural change. Built by the audio thread's
        :meth:`process_block` under the engine lock."""
        if self._processor is None:
            cfg = self.config
            w = self._get_dictionary()
            t0 = time.perf_counter()
            proc = RTGCCNMFProcessor(w, StreamConfig.from_app_config(cfg), device=self.device)
            if self.device.type == "cuda":
                fresh = proc.captured(1).state  # captured here, on this thread
                shape = (1, cfg.num_channels, cfg.block_size)
                self._slots = [_HostSlot(shape) for _ in range(self.pipeline_depth + 2)]
                self._next_slot = 0
            else:
                fresh = proc.init_state(1)
            if self._carry_state is not None:
                old_state, keep_localization = self._carry_state
                self._carry_state = None
                fresh = self._migrate_state(fresh, old_state, keep_localization)
            self._state = fresh
            w_host = np.array(w, np.float32)
            w_host.flags.writeable = False
            self._w_host = w_host
            self._processor = proc  # last: readers see a complete engine
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.rebuild_ms.append((time.perf_counter() - t0) * 1e3)
        return self._processor

    @staticmethod
    def _migrate_state(fresh, old, keep_localization: bool):
        """Carry compatible state across a structural engine rebuild, by
        copying into ``fresh`` (on the card the new graph's own state) in
        place before its first step; ``old`` may be freed afterwards.

        Audio-path leaves (input carry, OLA accumulator, delay FIFO) are
        preserved whenever their shapes match, so a mid-stream rebuild does
        not open an audible gap; localization leaves (GCC-PHAT history,
        target index) are only meaningful when the TDOA grid is unchanged
        (same num_tdoas AND mic separation — the grid spans ±d/c, so old
        indexes point elsewhere after a geometry change). The reference
        resets everything on these changes (gccNMFProcessor.py:157->233)."""
        keys = ["carry_in", "ola_acc", "delay_buf"]
        if keep_localization:
            keys += ["gcc_history", "hist_count", "target_idx"]
        for k in keys:
            dst, src = getattr(fresh, k), getattr(old, k)
            if dst.shape == src.shape:
                dst.copy_(src)
        return fresh

    def _drop_engine(self, keep_localization: bool) -> None:
        """Schedule a rebuild (under the engine lock): the current state is
        carried into the next engine, built at the next block."""
        if self._state is not None:
            self._carry_state = (self._state, keep_localization)
        self._processor = None
        self._state = None

    # ----------------------------------------------------- parameter control

    def set_target_window(
        self,
        target_tdoa_index: float | None = None,
        epsilon: float | None = None,
        beta: float | None = None,
        noise_floor: float | None = None,
    ) -> None:
        """Hot path: mask-window slider updates; nothing is re-captured
        (reference gccNMFProcessor.py:106-125, setTargetTDOARange)."""
        p = self.params
        if target_tdoa_index is not None:
            p = p._replace(target_tdoa_index=_f32(target_tdoa_index))
        if epsilon is not None:
            p = p._replace(target_epsilon=_f32(epsilon))
        if beta is not None:
            p = p._replace(target_beta=_f32(beta))
        if noise_floor is not None:
            p = p._replace(noise_floor=_f32(noise_floor))
        self.params = p

    def set_separation_enabled(self, enabled: bool) -> None:
        self.params = self.params._replace(
            separation_enabled=torch.tensor(bool(enabled))
        )

    def set_localization(self, enabled: bool, window_size: int | None = None) -> None:
        p = self.params._replace(localization_enabled=torch.tensor(bool(enabled)))
        if window_size is not None:
            p = p._replace(localization_window=torch.tensor(int(window_size), dtype=torch.int32))
        self.params = p

    def set_dictionary(self, size: int | None = None, type: str | None = None) -> None:
        """Slow path: structural change → rebuild engine
        (reference gccNMFProcessor.py:127-157). OLA/localization state is
        carried over (shapes are unaffected by the dictionary), so the swap
        is gap-free mid-stream — the reference resets instead."""
        with self._engine_lock:
            if size is not None:
                self.dictionary_size = size
                self.config = dc_replace(self.config, dictionary_size=size)
                self._activate_mask_history(size)
            if type is not None:
                self.dictionary_type = type
            self._drop_engine(keep_localization=True)

    def set_num_tdoas(self, num_tdoas: int) -> None:
        """Structural: new TDOA grid resolution (reference structural-reset
        list, gccNMFProcessor.py:131). Audio state survives; localization
        history/target reset (indexes are grid-relative); the target window
        center is re-centered on the new grid."""
        self._reconfigure(num_tdoas=int(num_tdoas))

    def set_mic_separation(self, metres: float) -> None:
        """Structural: new microphone geometry → new steering matrix. Audio
        state survives; localization state resets (the grid spans ±d/c, so
        history under the old d is meaningless)."""
        self._reconfigure(microphone_separation_in_metres=float(metres))

    def set_num_h_updates(self, n: int) -> None:
        """Structural: 0 = the reference's W-only realtime mask; N>0 adds N
        per-block H-inference steps and the H-aware Wiener mask (the
        reference plumbs numHUpdates but never uses it,
        gccNMFProcessor.py:195 vs :201-231). All state survives — only the
        mask computation changes."""
        if n < 0:
            raise ValueError("num_h_updates must be >= 0")
        self._reconfigure(num_h_updates=int(n))

    def set_target_mode(self, mode) -> None:
        """Structural: boxcar vs generalized-Gaussian coefficient mask
        (reference TARGET_MODE_* constants). All state survives — only the
        mask function changes."""
        parse_target_mode(mode)  # validate before committing
        self._reconfigure(target_mode=str(mode))

    def set_block_geometry(
        self,
        block_size: int | None = None,
        window_size: int | None = None,
        hop_size: int | None = None,
    ) -> None:
        """Structural: new STFT/block geometry. Everything rebuilds (every
        state shape depends on these); compatible leaves — e.g. the OLA
        accumulator when only the hop changes within the same window — are
        still carried."""
        changes = {
            k: int(v)
            for k, v in dict(
                block_size=block_size, window_size=window_size, hop_size=hop_size
            ).items()
            if v is not None
        }
        if not changes:
            return
        self._reconfigure(**changes)

    def _reconfigure(self, **changes) -> None:
        """Apply structural config changes and schedule an engine rebuild
        that preserves whatever state remains meaningful (the analogue of
        the reference's reset()-on-structural-param path,
        gccNMFProcessor.py:127-157, but state-preserving where possible)."""
        with self._engine_lock:
            old_cfg = self.config
            cfg = dc_replace(old_cfg, **changes)
            # validate BEFORE committing: a bad geometry must be rejected
            # here at the caller (GUI handler, control surface), not
            # surface as an opaque engine-rebuild exception on the audio
            # thread at the next block
            if cfg.block_size % cfg.hop_size:
                raise ValueError(
                    f"hop_size ({cfg.hop_size}) must divide block_size "
                    f"({cfg.block_size})"
                )
            if cfg.hop_size > cfg.window_size:
                raise ValueError(
                    f"hop_size ({cfg.hop_size}) must not exceed "
                    f"window_size ({cfg.window_size})"
                )
            if min(cfg.block_size, cfg.hop_size, cfg.window_size) < 1:
                raise ValueError("block/hop/window sizes must be positive")
            self.config = cfg
            # localization state is grid-relative: keep it only if the grid
            # (resolution AND physical span) is unchanged
            keep_localization = (
                cfg.num_tdoas == old_cfg.num_tdoas
                and cfg.microphone_separation_in_metres
                == old_cfg.microphone_separation_in_metres
            )
            stale_telemetry = False
            if cfg.num_tdoas != old_cfg.num_tdoas:
                self._histories["gcc_phat"] = CircularBuffer(
                    cfg.num_tdoas, cfg.num_tdoa_history
                )
                # the manual target window center is grid-relative too
                self.params = self.params._replace(
                    target_tdoa_index=_f32(cfg.num_tdoas / 2.0)
                )
                stale_telemetry = True
            if cfg.num_freq != old_cfg.num_freq:
                for key in ("input_spectrogram", "output_spectrogram"):
                    self._histories[key] = CircularBuffer(
                        cfg.num_freq, cfg.num_spectrogram_history
                    )
                stale_telemetry = True
                # dictionaries are per-window-size ((F, K) rows = num_freq):
                # drop the cached bank so the next block re-resolves for the
                # new F (the reference pretrains per windowSize the same
                # way, gccNMFPretraining.py:43-58). An explicit
                # dictionary_file keeps its F validation and will raise.
                self._dictionaries = None
            if stale_telemetry:
                self._clear_telemetry()
            self._drop_engine(keep_localization)

    # ------------------------------------------------------------------ run

    @property
    def histories(self) -> dict:
        """Telemetry ring buffers; reading drains pending telemetry (the
        fetch happens here, on the reader's clock, not per block)."""
        self.drain_telemetry()
        return self._histories

    def drain_telemetry(self) -> None:
        """Materialize queued telemetry into the host histories.

        Runs under the engine lock: :meth:`set_dictionary` clears the queue
        and swaps the mask buffer's width, and a drain racing that swap
        could apply an old-width mask to the new buffer; the drain's wait on
        the card must not overlap a capture either."""
        with self._engine_lock:
            self._drain_locked()

    def _drain_locked(self) -> None:
        tel = self._telemetry.drain() if self._telemetry is not None else None
        if tel is not None:
            self._update_histories(tel)

    def _push_telemetry(self, telemetry: dict) -> None:
        """Queue one block's telemetry (under the engine lock). A new
        engine whose telemetry has other shapes gets a new ring; what the
        old one still holds goes to the histories first."""
        ring = self._telemetry
        if ring is None or not ring.matches(telemetry):
            if ring is not None:
                self._drain_locked()
            ring = self._telemetry = _TelemetryRing(telemetry, self._telemetry_capacity)
        ring.push(telemetry)

    def _update_histories(self, tel: dict) -> None:
        """Append ``n`` blocks of telemetry (``(n, 1, m, ·)`` arrays, oldest
        first): m frames a block, each block's target index repeated m
        times, as the JAX app appends one block at a time."""
        h = self._histories
        n, _, m = tel["gcc_phat"].shape[:3]
        h["gcc_phat"].set(tel["gcc_phat"][:, 0].reshape(n * m, -1))
        h["tdoa"].set(np.repeat(tel["target_tdoa_index"][:, 0], m))
        h["input_spectrogram"].set(tel["input_mag"][:, 0].reshape(n * m, -1))
        h["output_spectrogram"].set(tel["output_mag"][:, 0].reshape(n * m, -1))
        h["coefficient_mask"].set(tel["coefficient_mask"][:, 0].reshape(n * m, -1))

    def _log_block_times(self) -> None:
        now = time.perf_counter()
        if now - self._last_log >= _TELEMETRY_LOG_INTERVAL_S:
            mn, mx, mean, n = self._block_times.stats()
            if n:
                logger.info(
                    "processing times (ms): min %.2f / avg %.2f / max %.2f"
                    " over last %d blocks",
                    mn * 1e3,
                    mean * 1e3,
                    mx * 1e3,
                    n,
                )
            self._last_log = now

    def block_time_stats(self) -> tuple[float, float, float, int]:
        """(min_s, max_s, mean_s, count) over the recent telemetry window."""
        return self._block_times.stats()

    def process_block(self, block: np.ndarray) -> np.ndarray | None:
        """Process one (C, block_size) block through the engine.

        With ``pipeline_depth == 0`` returns this block's output. With
        ``pipeline_depth == N`` returns the output of the block submitted N
        calls ago (``None`` while the pipeline fills); call :meth:`flush`
        after the last block to drain the tail.

        Thread-safe against the structural setters (the GUI's slow path);
        the uncontended lock costs nanoseconds next to the device step."""
        block = np.asarray(block, np.float32)
        with self._engine_lock:
            proc = self.processor
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                slot = self._slots[self._next_slot]
                self._next_slot = (self._next_slot + 1) % len(self._slots)
                slot.host_in.numpy()[0] = block
                self._state, out, telemetry = proc.step(self._state, slot.host_in, self.params)
                self._push_telemetry(telemetry)
                slot.host_out.copy_(out, non_blocking=True)
                slot.event.record()
                fetch = slot.fetch
            else:
                self._state, out, telemetry = proc.step(
                    self._state, torch.from_numpy(block[None]), self.params
                )
                self._push_telemetry(telemetry)

                def fetch(host=out[0].numpy().copy()):
                    return host

            self._inflight.append(fetch)
            ready = (
                self._inflight.popleft()
                if len(self._inflight) > self.pipeline_depth
                else None
            )
        out_np = ready() if ready is not None else None
        self._block_times.record(time.perf_counter() - t0)
        # hour-scale sessions: trim the loop's own allocator churn
        self._heap_trimmer.account(
            block.nbytes + (out_np.nbytes if out_np is not None else 0)
        )
        self._log_block_times()
        return out_np

    def flush(self) -> list[np.ndarray]:
        """Fetch the outputs still in the dispatch pipeline (oldest first)."""
        with self._engine_lock:
            pending, self._inflight = list(self._inflight), deque()
        return [fetch() for fetch in pending]

    def run(
        self,
        output_path: str | None = None,
        num_blocks: int | None = None,
        loop: bool = False,
        realtime: bool = False,
        source=None,
        output_stream=None,
        live_output: bool = False,
        streamed_output: bool = False,
    ) -> dict:
        """Stream a block source through the enhancer.

        ``source`` is any two-method block source (``.blocks()`` iterator +
        ``.sample_rate``) — :class:`FilePlayerSource` over ``audio_path``
        by default, or a :class:`LiveRingSource` fed by a device callback
        for live capture. Enhanced blocks go to the WAV sink
        (``output_path``) and/or a live ``output_stream`` (anything with
        ``write(block)``; see :class:`CallbackOutputStream` — the reference
        plays every enhanced block through a callback-clocked stream,
        audioProcessor.py:106-132). ``live_output=True`` asks
        :func:`open_output_stream` for a device-backed stream and falls
        back to sink-only when no audio stack exists.

        Returns stats: blocks processed, per-block wall-time percentiles,
        deadline misses, output-stream underrun/overrun counts (the
        device-clock deadline accounting), and the output path.
        """
        from gccnmf_torch.realtime.audio import open_output_stream

        cfg = self.config
        if source is None:
            source = FilePlayerSource(
                self.audio_path, cfg.block_size, loop=loop, realtime=realtime
            )
        if source.sample_rate != cfg.sample_rate:
            with self._engine_lock:
                self.config = dc_replace(self.config, sample_rate=source.sample_rate)
                self._processor = None
                self._state = None
        src_channels = getattr(source, "num_channels", None)
        if src_channels is not None and src_channels != cfg.num_channels:
            # fail up front with the actual problem — a mono file would
            # otherwise fail deep inside the step with an opaque
            # concatenate shape error after pretraining already ran
            raise ValueError(
                f"input has {src_channels} channel(s); this engine is "
                f"configured for {cfg.num_channels} (GCC-PHAT needs a "
                f"stereo microphone pair)"
            )
        # build the engine (on the card: capture its graph) before the first
        # block's clock starts; a rebuild mid-run still shows in the times
        with self._engine_lock:
            self.processor  # noqa: B018
        # StreamingSink keeps host RAM at O(block) for unbounded runs
        # (per-sample clipping instead of WavSink's whole-file rescale)
        sink_cls = StreamingSink if streamed_output else WavSink
        sink = (
            sink_cls(output_path, source.sample_rate, cfg.num_channels)
            if output_path
            else None
        )
        opened_stream = False
        if output_stream is None and live_output:
            output_stream = open_output_stream(
                source.sample_rate, cfg.num_channels, cfg.block_size
            )
            opened_stream = output_stream is not None

        deadline = cfg.block_size / source.sample_rate

        def stream_out(out) -> None:
            # backpressure when the stream supports it: a non-realtime
            # source outruns the callback-clocked ring by design, and
            # plain write() would drop everything past the first 8
            # blocks as overruns; the timeout keeps a stalled/absent
            # backend from hanging the loop
            wb = getattr(output_stream, "write_blocking", None)
            if wb is not None:
                wb(out, timeout=max(0.5, 16 * deadline))
            else:
                output_stream.write(out)

        times: list[float] = []
        count = 0
        for block in source.blocks():
            t0 = time.perf_counter()
            out = self.process_block(block)
            times.append(time.perf_counter() - t0)
            if out is not None:
                if sink is not None:
                    sink.write(out)
                if output_stream is not None:
                    stream_out(out)
            count += 1
            if num_blocks is not None and count >= num_blocks:
                break
        # drain the dispatch pipeline so the sink holds every block's output
        # (the file is then bit-identical to an unpipelined run)
        for out in self.flush():
            if sink is not None:
                sink.write(out)
            if output_stream is not None:
                stream_out(out)

        stats = dict(
            blocks=count,
            p50_ms=round(float(np.percentile(times, 50)) * 1e3, 3) if times else None,
            p99_ms=round(float(np.percentile(times, 99)) * 1e3, 3) if times else None,
            deadline_ms=round(deadline * 1e3, 3),
            deadline_misses=int(np.sum(np.asarray(times) > deadline)) if times else 0,
            # exceeded=True means recycle the worker before the host OOMs
            host_mem=HostMemWatchdog(min_interval_s=0.0).check(),
            host_heap_trims=self._heap_trimmer.trims,
        )
        if output_stream is not None:
            # the callback clock's verdict on the same run (live path)
            stats["output_underruns"] = getattr(output_stream, "underruns", 0)
            stats["output_overruns"] = getattr(output_stream, "overruns", 0)
            if opened_stream:
                output_stream.close()
        if sink is not None:
            stats["output"] = sink.close()
        return stats
