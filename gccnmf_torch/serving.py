"""Multi-stream serving for RT-GCC-NMF (counterpart of ``gccnmf_tpu/serving.py``).

The per-block program is the same for every stream, so the server is a
fixed-slot lockstep batch: one step over ``(max_streams, C, block)`` with
per-slot state, run once per block interval, streams joining and leaving
without rebuilding anything. On a CUDA device that step is one captured CUDA
graph at ``max_streams`` (``models/realtime.CapturedStep``):

- opening a stream writes a fresh state into its slot's rows, in place;
- per-stream settings are batched parameter tensors (``(B,)`` and
  ``(B, 1, 1)``), copied into the graph's own only when settings change;
- a tick writes its blocks into a pinned host buffer, copies them to the
  card, replays the graph and copies the output (and the localized target,
  for :attr:`StreamServer.telemetry`) back into pinned buffers, all on the
  compute stream without waiting; a CUDA event recorded after the copies is
  what a fetch waits on. With ``pipeline_depth`` N > 0 the tick returns the
  output of the tick N calls ago, so the card's round trip leaves the
  deadline path;
- the int16 wire ships 16-bit PCM both ways; the host clips and casts the
  input, the graph converts to float and back.

Inactive slots process silence and their outputs are discarded, so the
per-tick work is the same at any tenancy. The step never mixes slots, and
its argmax inputs are batch-invariant (``models/realtime.py``): a served
stream gives what it gives through a batch-1 processor. On the CPU the same
tick runs the eager step.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from gccnmf_torch.models.realtime import (
    CapturedStep, RTGCCNMFProcessor, StreamConfig, StreamParams, StreamState, reset_slot,
)
from gccnmf_torch.native import BlockTimes
from gccnmf_torch.utils.hostmem import HostMemWatchdog, PeriodicTrim

__all__ = ["StreamSettings", "StreamServer"]

# PCM full scale and the largest value the WAV writer keeps (utils/wav.py)
PCM_SCALE = 32768.0
PCM_MAX = 1.0 - 2.0**-15


def pcm_to_float(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) / PCM_SCALE


def float_to_pcm(x: torch.Tensor) -> torch.Tensor:
    """The WAV writer's quantization (clip to [-1, 1 - 2^-15], scale,
    truncate). NaN becomes 0, as JAX's conversion gives on the CPU; torch
    leaves a NaN cast undefined."""
    y = torch.clamp(x, -1.0, PCM_MAX) * PCM_SCALE
    return torch.where(torch.isnan(y), 0.0, y).to(torch.int16)


class _FetchWorker:
    """Serial device→host fetcher on its own thread (``async_fetch``).

    The tick enqueues ``(fetch, submitted, t_dispatch)``, where ``fetch()``
    waits for that tick's copy and returns its output as NumPy; the worker
    calls them in FIFO order and parks the results. ``take`` does not block
    until the number of outstanding ticks exceeds the pipeline depth, and
    then waits for the OLDEST result only: a late copy delays delivery,
    never reorders it."""

    def __init__(self):
        self._in: queue.Queue = queue.Queue()
        self._done: queue.Queue = queue.Queue()
        self.outstanding = 0  # accessed from the tick thread only
        self._thread = threading.Thread(target=self._run, name="gccnmf-serving-fetch",
                                        daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._in.get()
            if item is None:
                return
            fetch, submitted, t_dispatch = item
            try:
                out_np = fetch()
            except Exception as e:  # surface on the tick thread, never
                # strand take(block=True)
                self._done.put(e)
                continue
            self._done.put((out_np, submitted, t_dispatch, time.perf_counter()))

    def submit(self, fetch, submitted: dict, t_dispatch: float) -> None:
        self.outstanding += 1
        self._in.put((fetch, submitted, t_dispatch))

    def take(self, block: bool):
        """Oldest completed ``(out_np, submitted, t_dispatch, t_done)``, or
        None when nothing is ready and ``block`` is False. Re-raises a fetch
        failure on the caller's thread."""
        try:
            item = self._done.get(block=block)
        except queue.Empty:
            return None
        self.outstanding -= 1
        if isinstance(item, Exception):
            raise item
        return item

    def drain(self) -> list:
        """Wait for every outstanding tick (flush/teardown path)."""
        items = []
        while self.outstanding:
            items.append(self.take(block=True))
        return items

    def stop(self) -> None:
        self._in.put(None)
        self._thread.join(timeout=5)


@dataclass
class StreamSettings:
    """Per-stream control settings (host-side; see StreamParams)."""

    target_tdoa_index: float = 32.0
    target_epsilon: float = 5.0
    target_beta: float = 2.0
    noise_floor: float = 0.0
    separation_enabled: bool = True
    localization_enabled: bool = True
    localization_window: int = 6


class _PinnedSlot:
    """One tick's pinned host buffers and the event a fetch waits on."""

    def __init__(self, shape, dtype):
        self.host_in = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.host_out = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.event = torch.cuda.Event()

    def fetch(self) -> np.ndarray:
        self.event.synchronize()
        return self.host_out.numpy().copy()


class StreamServer:
    """Lockstep multi-stream RT-GCC-NMF enhancement server.

    ``pipeline_depth``: N > 0 makes :meth:`process` return the outputs of the
    tick submitted N calls ago (an empty dict while the pipeline fills;
    :meth:`flush` drains the tail). ``async_fetch``: with N > 0, outputs are
    fetched on a worker thread, so a late copy delays that delivery (bounded
    by backpressure at N outstanding ticks) instead of the tick;
    ``tick_stats()['delivery_ms']`` then reports dispatch→delivery latency.
    ``wire_dtype="int16"`` ships blocks and outputs as 16-bit PCM (half the
    bytes each way); the API stays float32, the outputs quantized as the WAV
    writer would. ``device=None`` serves on the card; ``mesh`` (slot
    sharding over several devices) is not ported yet and raises (ROADMAP.md,
    Queue 1 item 6c)."""

    def __init__(
        self,
        w,
        config: StreamConfig = StreamConfig(),
        max_streams: int = 8,
        pipeline_depth: int = 0,
        async_fetch: bool = False,
        wire_dtype: str = "float32",
        device=None,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError("StreamServer(mesh=): slot sharding over several devices "
                                      "is not ported yet (ROADMAP.md, Queue 1 item 6c)")
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype must be float32 or int16: {wire_dtype}")
        if pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        self.processor = RTGCCNMFProcessor(w, config, device=device)
        self.device = self.processor.device
        self.config = config
        self.max_streams = max_streams
        self.wire_dtype = wire_dtype
        self.pipeline_depth = pipeline_depth
        int16 = wire_dtype == "int16"
        self._wire = (pcm_to_float, float_to_pcm) if int16 else (None, None)
        self._fresh_slot_state = self.processor.init_state(1)
        if self.device.type == "cuda":
            self._graph = CapturedStep(self.processor, max_streams,
                                       torch.int16 if int16 else torch.float32, *self._wire)
            self._state = self._graph.state
            shape = (max_streams, config.num_channels, config.block_size)
            # a slot's buffers are reused pipeline_depth + 2 ticks later,
            # after its fetch has copied the output out
            self._ring = [_PinnedSlot(shape, self._graph.block.dtype)
                          for _ in range(pipeline_depth + 2)]
            self._tel_host = torch.empty(max_streams, pin_memory=True)
            self._tel_event = torch.cuda.Event()
        else:
            self._state = self.processor.init_state(max_streams)
        self._settings: list[StreamSettings | None] = [None] * max_streams
        self._next_id = 0
        self._ids: dict[int, int] = {}  # stream_id -> slot
        self._blocks_processed = 0
        # params are uploaded once per settings change, not per tick, and
        # telemetry is read lazily
        self._params_cache: StreamParams | None = None
        self._pending_telemetry = None
        self._telemetry_cache = None
        # (fetch, {stream_id: slot} at dispatch time) awaiting fetch
        self._inflight: list = []
        self._fetcher = _FetchWorker() if (async_fetch and pipeline_depth > 0) else None
        # per-tick deadline accounting on the serving clock: every tick must
        # complete within one block interval or every tenant glitches at
        # once; percentiles over a bounded window of the native tier's
        # block-time ring, cumulative counters
        self.deadline_s = config.block_size / config.sample_rate
        self._tick_times = BlockTimes(capacity=1024)
        self._delivery_times = BlockTimes(capacity=1024)  # async_fetch only
        self._heap_trimmer = PeriodicTrim()
        self._mem_watchdog = HostMemWatchdog()
        self.ticks = 0
        self.deadline_misses = 0

    # ----------------------------------------------------------- lifecycle

    @property
    def active_streams(self) -> int:
        return len(self._ids)

    def open_stream(self, settings: StreamSettings | None = None) -> int:
        """Claim a free slot → stream id. Raises when fully tenanted."""
        try:
            slot = self._settings.index(None)
        except ValueError:
            raise RuntimeError(f"all {self.max_streams} stream slots busy") from None
        # a private copy: one StreamSettings shared across open_stream calls
        # must not let update_stream on one tenant change the others
        self._settings[slot] = replace(settings) if settings else StreamSettings()
        self._params_cache = None
        self._reset_slot(slot)
        stream_id = self._next_id
        self._next_id += 1
        self._ids[stream_id] = slot
        return stream_id

    def close_stream(self, stream_id: int) -> None:
        slot = self._ids.pop(stream_id)
        self._settings[slot] = None
        self._params_cache = None

    def update_stream(self, stream_id: int, **changes) -> None:
        """Adjust a live stream's settings (nothing is re-captured).
        All-or-nothing: every key is checked before any is applied."""
        s = self._settings[self._ids[stream_id]]
        unknown = [k for k in changes if not hasattr(s, k)]
        if unknown:
            raise AttributeError(f"unknown stream setting(s): {', '.join(sorted(unknown))}")
        for key, value in changes.items():
            setattr(s, key, value)
        self._params_cache = None

    # ------------------------------------------------------------- stepping

    def _reset_slot(self, slot: int) -> None:
        """A fresh state in one slot's rows: in place on the graph's state
        on CUDA; on the CPU into new tensors, since the last tick's
        telemetry shares the target leaf."""
        if self.device.type != "cuda":
            self._state = StreamState(*(leaf.clone() for leaf in self._state))
        reset_slot(self._state, self._fresh_slot_state, slot)

    def _from_wire(self, out_np: np.ndarray) -> np.ndarray:
        """A fetched tick output → the float32 API currency."""
        if self.wire_dtype == "int16":
            return out_np.astype(np.float32) / PCM_SCALE
        return out_np

    def _batched_params(self) -> StreamParams:
        b = self.max_streams
        cols = {f: np.empty(b, np.float64) for f in (
            "target_tdoa_index", "target_epsilon", "target_beta", "noise_floor",
            "localization_window",
        )}
        sep = np.zeros(b, bool)
        loc = np.zeros(b, bool)
        default = StreamSettings()
        for slot in range(b):
            s = self._settings[slot] or default
            for f in cols:
                cols[f][slot] = getattr(s, f)
            sep[slot] = s.separation_enabled and self._settings[slot] is not None
            loc[slot] = s.localization_enabled

        def t(x, dtype, shape):
            return torch.as_tensor(x, dtype=dtype).reshape(shape)

        return StreamParams(
            target_tdoa_index=t(cols["target_tdoa_index"], torch.float32, (b,)),
            target_epsilon=t(cols["target_epsilon"], torch.float32, (b, 1, 1)),
            target_beta=t(cols["target_beta"], torch.float32, (b, 1, 1)),
            noise_floor=t(cols["noise_floor"], torch.float32, (b, 1, 1)),
            separation_enabled=t(sep, torch.bool, (b, 1, 1)),
            localization_enabled=t(loc, torch.bool, (b,)),
            localization_window=t(cols["localization_window"], torch.int32, (b,)),
        )

    def _dispatch(self, wire: np.ndarray):
        """Run one tick on ``wire`` (the slot batch in the wire dtype) and
        return ``fetch()``, which waits for its output and returns it as
        NumPy in the wire dtype. Telemetry is copied out the same way."""
        if self.device.type != "cuda":
            pre, post = self._wire
            x = torch.from_numpy(wire)
            state, out, tel = self.processor.eager_step(
                self._state, x if pre is None else pre(x), self._params_cache)
            self._state = state
            out = out if post is None else post(out)
            self._tel = tel["target_tdoa_index"]
            out_np = out.contiguous().numpy().copy()
            return lambda: out_np
        g = self._graph
        slot = self._ring[self._blocks_processed % len(self._ring)]
        slot.host_in.numpy()[...] = wire
        g.block.copy_(slot.host_in, non_blocking=True)
        g.graph.replay()
        slot.host_out.copy_(g.out, non_blocking=True)
        self._tel_host.copy_(g.telemetry["target_tdoa_index"], non_blocking=True)
        self._tel_event.record()
        slot.event.record()
        return slot.fetch

    def process(self, blocks: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
        """One lockstep tick: ``{stream_id: (C, block)}`` in → same out.

        Streams without a block this tick receive silence (their OLA and
        localization state still advance). Unknown ids raise. Returns each
        submitted stream's enhanced block, or, with ``pipeline_depth`` N > 0,
        the outputs of the tick N calls ago (the empty dict while the
        pipeline fills); ``telemetry`` holds the latest tick's."""
        t0 = time.perf_counter()
        cfg = self.config
        expect = (cfg.num_channels, cfg.block_size)
        batch = np.zeros((self.max_streams,) + expect, np.float32)
        for stream_id, block in blocks.items():
            block = np.asarray(block)
            if block.shape != expect:
                # a (block,) or (1, block) mono submission would broadcast
                # into both channels: degenerate GCC-PHAT and no error
                raise ValueError(
                    f"stream {stream_id}: block shape {block.shape} != expected {expect}"
                )
            batch[self._ids[stream_id]] = block
        if self._params_cache is None:
            self._params_cache = self._batched_params()
            if self.device.type == "cuda":
                self._graph.set_params(self._params_cache)
        if self.wire_dtype == "int16":
            wire = np.clip(batch * PCM_SCALE, -32768.0, 32767.0).astype(np.int16)
        else:
            wire = batch
        fetch = self._dispatch(wire)
        self._blocks_processed += 1
        self._pending_telemetry = dict(self._ids)
        self._telemetry_cache = None  # a new tick invalidates the last read
        # ids are recorded at dispatch: a stream closed (or its slot
        # re-tenanted) before its output surfaces still gets its own audio
        submitted = {s: self._ids[s] for s in blocks}
        if self.pipeline_depth:
            if self._fetcher is not None:
                self._fetcher.submit(fetch, submitted, t0)
                item = self._fetcher.take(block=self._fetcher.outstanding > self.pipeline_depth)
                if item is None:
                    self._record_tick(t0)
                    return {}
                out_np, submitted, t_dispatch, t_done = item
                self._delivery_times.record(t_done - t_dispatch)
                out_np = self._from_wire(out_np)
                result = {sid: out_np[slot] for sid, slot in submitted.items()}
                self._heap_trimmer.account(batch.nbytes + out_np.nbytes)
                self._record_tick(t0)
                return result
            self._inflight.append((fetch, submitted))
            if len(self._inflight) <= self.pipeline_depth:
                self._record_tick(t0)
                return {}
            fetch, submitted = self._inflight.pop(0)
        out_np = self._from_wire(fetch())
        result = {sid: out_np[slot] for sid, slot in submitted.items()}
        # long-running serving: trim the allocator's churn every ~256 MB
        self._heap_trimmer.account(batch.nbytes + out_np.nbytes)
        self._record_tick(t0)
        return result

    def _record_tick(self, t0: float) -> None:
        dt = time.perf_counter() - t0
        self._tick_times.record(dt)
        self.ticks += 1
        if dt > self.deadline_s:
            self.deadline_misses += 1

    def tick_stats(self) -> dict:
        """Serving-clock health: cumulative tick and deadline-miss counters
        plus wall-time stats over the recent (bounded) window. p50/p99 are
        the capacity metric: a tenancy serves safely while p99 stays under
        ``deadline_ms``."""
        # one window snapshot for every statistic, so they agree
        window = self._tick_times.snapshot()
        if window.size:
            mn, mx, mean = float(window.min()), float(window.max()), float(window.mean())
            p50, p99 = (float(np.percentile(window, q)) for q in (50.0, 99.0))
        else:
            mn = mx = mean = p50 = p99 = 0.0
        return dict(
            ticks=self.ticks,
            deadline_ms=round(self.deadline_s * 1e3, 3),
            deadline_misses=self.deadline_misses,
            tick_ms=dict(
                min=round(mn * 1e3, 3),
                mean=round(mean * 1e3, 3),
                p50=round(p50 * 1e3, 3),
                p99=round(p99 * 1e3, 3),
                max=round(mx * 1e3, 3),
                window=int(window.size),
            ),
            host_mem=self._mem_watchdog.check(),
            host_heap_trims=self._heap_trimmer.trims,
            # async_fetch: dispatch→delivery latency of returned ticks (the
            # deployment metric once the fetch is off the tick path)
            delivery_ms=self._delivery_stats(),
        )

    def _delivery_stats(self) -> dict | None:
        window = self._delivery_times.snapshot()
        if not window.size:
            return None
        p50, p99 = (float(np.percentile(window, q)) for q in (50.0, 99.0))
        return dict(
            p50=round(p50 * 1e3, 3),
            p99=round(p99 * 1e3, 3),
            max=round(float(window.max()) * 1e3, 3),
            window=int(window.size),
        )

    def flush(self) -> list[dict[int, np.ndarray]]:
        """Drain pipelined ticks (oldest first) after the last submit."""
        if self._fetcher is not None:
            items = self._fetcher.drain()
            for _, _, t_dispatch, t_done in items:
                self._delivery_times.record(t_done - t_dispatch)
            return [
                {sid: self._from_wire(out_np)[slot] for sid, slot in submitted.items()}
                for out_np, submitted, _, _ in items
            ]
        pending, self._inflight = self._inflight, []
        return [
            {sid: self._from_wire(fetch())[slot] for sid, slot in submitted.items()}
            for fetch, submitted in pending
        ]

    def close(self) -> None:
        """Stop the async fetch worker. Outstanding tick outputs are waited
        for and discarded: call :meth:`flush` first to keep them.
        Idempotent."""
        if self._fetcher is not None:
            self._fetcher.drain()
            self._fetcher.stop()
            self._fetcher = None

    @property
    def telemetry(self) -> dict[int, dict]:
        """Per-stream telemetry of the latest tick (read once per tick)."""
        if self._pending_telemetry is None:
            return {}
        if self._telemetry_cache is None:
            if self.device.type == "cuda":
                self._tel_event.synchronize()
                self._telemetry_cache = self._tel_host.numpy().copy()
            else:
                self._telemetry_cache = self._tel.numpy().copy()
        tdoa = self._telemetry_cache
        return {
            sid: dict(target_tdoa_index=float(tdoa[slot]))
            for sid, slot in self._pending_telemetry.items()
        }
