"""Audio block sources and sinks for the realtime runtime (counterpart of
``gccnmf_tpu/realtime/audio.py``).

The reference's audio layer is a dedicated OS process wrapping a PyAudio
output stream whose callback slices PCM from a preloaded WAV, hands blocks
to the DSP process over shared memory, and blocks on an Event until the DSP
is done (reference: gccNMF/realtime/audioProcessor.py:35-208). Here the
audio layer is a plain iterator/callback pair in the app's host loop, and
the order of the device's stream replaces the Event handshake.

``FilePlayerSource`` reproduces the file-player behavior: loads a WAV once,
yields fixed-size float32 blocks, optionally looping and optionally paced to
the real-time block deadline. A PyAudio/sounddevice live-device source can
implement the same two-method protocol; neither library is a dependency,
so the live path is gated behind an optional import.
"""

from __future__ import annotations

import logging
import time
from typing import Iterator

import numpy as np

from gccnmf_torch.utils import wav as wavio

logger = logging.getLogger(__name__)

__all__ = [
    "FilePlayerSource",
    "LiveRingSource",
    "WavSink",
    "StreamingSink",
    "CallbackOutputStream",
    "open_output_stream",
    "open_input_stream",
]


class FilePlayerSource:
    """Iterates (num_channels, block_size) float32 blocks from a WAV file.

    ``loop=True`` wraps around at EOF like the reference's file player
    (audioProcessor.py:106-115); ``realtime=True`` sleeps to pace blocks at
    the 32 ms deadline (block_size / sample_rate) instead of free-running.
    """

    def __init__(
        self,
        path: str,
        block_size: int = 512,
        loop: bool = False,
        realtime: bool = False,
    ):
        # mmap-backed range reads: an hour-long input costs O(block) host
        # RAM on the streaming path, not O(file) (WavReader falls back to
        # an in-memory read only for 24-bit payloads scipy cannot mmap)
        self._reader = wavio.WavReader(path)
        self.sample_rate = self._reader.sample_rate
        self._num_samples = self._reader.num_samples
        if self._num_samples < block_size:
            # looping such a file would yield undersized blocks forever
            raise ValueError(
                f"{path}: {self._num_samples} samples is shorter than "
                f"one {block_size}-sample block"
            )
        #: channel count of the underlying file — consumers (app.run, GUI
        #: pump) validate this against their engine's num_channels up
        #: front, instead of failing deep inside the step on a mono input
        #: with an opaque concatenate shape error
        self.num_channels = self._reader.num_channels
        self.block_size = block_size
        self.loop = loop
        self.realtime = realtime
        self.position = 0

    @property
    def samples(self) -> np.ndarray:
        """The whole file as (C, n) float32 — materializes on demand for
        inspection; the block path never does."""
        return self._reader.read(0, self._num_samples)

    @property
    def num_blocks(self) -> int:
        return self._num_samples // self.block_size

    def blocks(self) -> Iterator[np.ndarray]:
        deadline = self.block_size / self.sample_rate
        next_t = time.perf_counter()
        n = self._num_samples
        while True:
            if self.position + self.block_size > n:
                if not self.loop:
                    return
                self.position = 0
            block = self._reader.read(self.position, self.block_size)
            self.position += self.block_size
            if self.realtime:
                next_t += deadline
                delay = next_t - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            yield block

    def seek(self, sample: int) -> None:
        self.position = int(sample)


class LiveRingSource:
    """Block source fed by a live audio callback through the native ring.

    The producer side (an audio-device callback thread) calls
    ``push_interleaved_pcm16(frames)`` or ``push_planar(block)``; the
    consumer side (the DSP host loop) iterates ``blocks()``. The exchange
    is the lock-free SPSC ring from the native runtime
    (gccnmf_torch/native/src/gccnmf_rt.cpp), replacing the reference's
    shared-memory frame arrays + Event handshake
    (runRealtimeGCCNMF.py:68-72, audioProcessor.py:118-122): the callback
    never blocks on the DSP — if the DSP falls behind, blocks are dropped at
    the ring (counted in ``overruns``) instead of stalling the device.
    """

    def __init__(
        self,
        sample_rate: int = 16000,
        num_channels: int = 2,
        block_size: int = 512,
        capacity_blocks: int = 16,
    ):
        from gccnmf_torch import native

        self.sample_rate = sample_rate
        self.num_channels = num_channels
        self.block_size = block_size
        self._samples_per_block = num_channels * block_size
        self._ring = native.SpscRing(capacity_blocks * self._samples_per_block)
        self.overruns = 0
        self.closed = False
        #: optional device backend (an object with .stop()); set by
        #: :func:`open_input_stream` when a real audio stack exists
        self.backend = None

    # ------------------------------------------------- producer (callback)

    def push_interleaved_pcm16(self, frames: np.ndarray) -> bool:
        """Push interleaved int16 device frames; False if the ring was full."""
        from gccnmf_torch import native

        planar = native.deinterleave_pcm16(frames, self.num_channels)
        return self.push_planar(planar)

    def push_planar(self, block: np.ndarray) -> bool:
        """Push a (num_channels, n) float32 block; False on overrun.

        All-or-nothing: a partial write would desync channel framing, so the
        whole block is dropped when the ring lacks space (the SPSC contract
        makes the writable() check safe — only this thread ever writes).
        """
        flat = np.ascontiguousarray(block, np.float32).ravel()
        if flat.size != self._samples_per_block:
            # a wrong-shaped write would permanently desync the consumer's
            # fixed-size reads (mixed halves of adjacent pushes, swapped
            # channel planes) — reject it before it reaches the ring
            raise ValueError(
                f"push_planar expects ({self.num_channels}, "
                f"{self.block_size}), got shape {np.shape(block)}"
            )
        if self._ring.writable() < flat.size:
            self.overruns += 1
            return False
        self._ring.write(flat)
        return True

    def close(self) -> None:
        self.closed = True
        backend = self.backend
        self.backend = None
        if backend is not None:
            try:  # pragma: no cover - device-dependent
                backend.stop()
            except Exception:
                logger.warning("audio input backend failed to stop", exc_info=True)

    # --------------------------------------------------- consumer (DSP loop)

    def blocks(self) -> Iterator[np.ndarray]:
        """Yield (num_channels, block_size) blocks; waits for the producer."""
        n = self._samples_per_block
        while True:
            if self._ring.readable() >= n:
                flat = self._ring.read(n)
                yield flat.reshape(self.num_channels, self.block_size)
                continue
            if self.closed:
                # The producer can push its final blocks AND close between
                # our readable() sample and this flag read (ctypes releases
                # the GIL during the foreign call) — re-check before
                # stopping or the stream's tail is dropped. After closed
                # is observed no new writes can arrive, so a second
                # below-threshold reading is final.
                if self._ring.readable() < n:
                    return
                continue
            time.sleep(0.001)


class WavSink:
    """Accumulates output blocks and writes one WAV on ``close()``.

    Buffers the whole signal so ``close()`` can apply the reference's
    whole-file clip-protection rescale (wavfile.py:40-44) — O(stream)
    host RAM. For hour-scale runs use :class:`StreamingSink` (O(block)
    RAM, per-sample clipping instead of the rescale)."""

    def __init__(self, path: str, sample_rate: int, num_channels: int = 2):
        self.path = path
        self.sample_rate = sample_rate
        self.num_channels = num_channels
        self._chunks: list[np.ndarray] = []

    def write(self, block: np.ndarray) -> None:
        self._chunks.append(np.asarray(block, np.float32))

    def close(self) -> str:
        out = (
            np.concatenate(self._chunks, axis=-1)
            if self._chunks
            else np.zeros((self.num_channels, 0), np.float32)
        )
        wavio.write_wav(out, self.path, self.sample_rate)
        return self.path


class StreamingSink:
    """Incremental output sink: O(block) host RAM for unbounded streams.

    Same two-method protocol as :class:`WavSink`, backed by
    :class:`gccnmf_torch.utils.wav.StreamingWavWriter` — samples hit disk
    as they arrive, so clip protection is per-sample clipping (counted,
    warned on close) instead of the whole-file rescale; the documented
    divergence of every streamed output path."""

    def __init__(self, path: str, sample_rate: int, num_channels: int = 2):
        self.path = path
        self.sample_rate = sample_rate
        self._writer = wavio.StreamingWavWriter(
            path, sample_rate, num_channels
        )

    def write(self, block: np.ndarray) -> None:
        self._writer.write(np.asarray(block, np.float32))

    def close(self) -> str:
        return self._writer.close()


class CallbackOutputStream:
    """Callback-clocked live audio output.

    The reference routes every enhanced block back into a PyAudio output
    stream whose device callback pulls interleaved frames on the hardware
    clock (reference createAudioStream + the write path,
    gccNMF/realtime/audioProcessor.py:106-132,183-208). Here the exchange
    is the same lock-free SPSC ring the input side uses
    (gccnmf_torch/native/src/gccnmf_rt.cpp): the DSP loop ``write()``s planar
    enhanced blocks (interleaved into the ring), the device callback
    thread ``callback(num_frames)``s fixed-size interleaved frames —
    neither side ever blocks the other.

    Accounting makes the callback clock the deadline arbiter:

    - ``underruns``: the callback found fewer frames than the device asked
      for — the DSP missed the hardware deadline; the gap plays as silence.
    - ``overruns``: ``write()`` found the ring full (the device stalled or
      the writer is ahead of real time) — the block is dropped, the write
      returns ``False``.
    """

    def __init__(
        self,
        sample_rate: int,
        num_channels: int = 2,
        block_size: int = 512,
        capacity_blocks: int = 8,
    ):
        from gccnmf_torch import native

        self.sample_rate = sample_rate
        self.num_channels = num_channels
        self.block_size = block_size
        self._ring = native.SpscRing(capacity_blocks * num_channels * block_size)
        self.underruns = 0
        self.overruns = 0
        self.frames_written = 0
        self.frames_played = 0
        self.closed = False
        # underruns only count once the first write has landed: the device
        # callback starts firing immediately while the DSP side is still
        # capturing its first step, and charging that warm-up as hundreds
        # of "missed deadlines" would make the health metric unusable
        self._started = False
        #: optional device backend (an object with .stop()); set by
        #: :func:`open_output_stream` when a real audio stack exists
        self.backend = None

    # ----------------------------------------------------- writer (DSP loop)

    def write(self, block: np.ndarray) -> bool:
        """Queue a planar (num_channels, n) float32 block; False on overrun.

        All-or-nothing like the input ring: a partial write would desync
        the interleaved frame framing.
        """
        block = np.asarray(block, np.float32)
        if block.ndim != 2 or block.shape[0] != self.num_channels:
            raise ValueError(
                f"write expects ({self.num_channels}, n), got {block.shape}"
            )
        if self.closed:  # close() documents "stop accepting writes"
            return False
        flat = np.ascontiguousarray(block.T).ravel()  # interleave frames
        if self._ring.writable() < flat.size:
            self.overruns += 1
            return False
        self._ring.write(flat)
        self.frames_written += block.shape[1]
        self._started = True
        return True

    def write_blocking(self, block: np.ndarray, timeout: float | None = None) -> bool:
        """:meth:`write` with backpressure: wait for ring space instead of
        dropping. A faster-than-realtime producer (file source without
        pacing) outruns the callback clock by design — the callback IS
        the clock (reference audioProcessor.py:106-132), so the producer
        should block on it, not flood an 8-block ring. Counts a single
        overrun only on timeout (stalled/absent backend)."""
        block = np.asarray(block, np.float32)
        need = block.size
        step = max(self.block_size / self.sample_rate / 4.0, 1e-4)
        t_end = None if timeout is None else time.perf_counter() + timeout
        while not self.closed and self._ring.writable() < need:
            if t_end is not None and time.perf_counter() >= t_end:
                self.overruns += 1
                return False
            time.sleep(step)
        return self.write(block)

    @property
    def pending_frames(self) -> int:
        """Frames queued but not yet pulled by the callback."""
        return self._ring.readable() // self.num_channels

    # ---------------------------------------------- reader (device callback)

    def callback(self, num_frames: int) -> np.ndarray:
        """Pull ``num_frames`` interleaved frames on the device clock.

        Returns a ``(num_frames, num_channels)`` float32 array; a shortfall
        is padded with silence and counted as one underrun (unless the
        stream is closed and simply draining its tail).
        """
        c = self.num_channels
        want = num_frames * c
        # writes are whole frames, so readable() is a multiple of c
        got = min(want, self._ring.readable())
        out = np.zeros(want, np.float32)
        if got:
            out[:got] = self._ring.read(got)
        if got < want and not self.closed and self._started:
            self.underruns += 1
        self.frames_played += got // c
        return out.reshape(num_frames, c)

    def close(self) -> None:
        """Stop accepting writes; stop the device backend if one is attached.
        The callback may keep firing to drain the tail — post-close
        shortfalls are expected and not counted as underruns."""
        self.closed = True
        backend = self.backend
        self.backend = None
        if backend is not None:
            try:  # pragma: no cover - device-dependent
                backend.stop()
            except Exception:
                logger.warning("audio output backend failed to stop", exc_info=True)


def _sounddevice_output_backend(stream: "CallbackOutputStream"):
    """Clock ``stream.callback`` from a sounddevice OutputStream, or None.

    sounddevice is optional; deployments with a host audio stack get the
    real device clock, everything else falls back cleanly.
    """
    try:  # pragma: no cover - depends on optional host audio stack
        import sounddevice  # type: ignore

        def cb(outdata, frames, _time, _status):
            outdata[:] = stream.callback(frames)

        dev = sounddevice.OutputStream(
            samplerate=stream.sample_rate,
            channels=stream.num_channels,
            blocksize=stream.block_size,
            dtype="float32",
            callback=cb,
        )
        dev.start()
        return dev
    except Exception:
        return None


def open_output_stream(
    sample_rate: int,
    num_channels: int,
    block_size: int,
    backend_factory=None,
):
    """Live audio output: a :class:`CallbackOutputStream` clocked by a
    device backend, or ``None`` when no backend exists (the realtime app
    falls back to a WavSink / discard).

    ``backend_factory(stream) -> backend|None`` is injectable so headless
    tests can drive the full source→engine→output-callback path with a mock
    clock (reference equivalent: createAudioStream,
    audioProcessor.py:183-208).
    """
    stream = CallbackOutputStream(sample_rate, num_channels, block_size)
    factory = backend_factory or _sounddevice_output_backend
    backend = factory(stream)
    if backend is None:
        logger.info("no live audio output backend available; use WavSink")
        return None
    stream.backend = backend
    return stream


def open_input_stream(
    sample_rate: int,
    num_channels: int,
    block_size: int,
    backend_factory=None,
):
    """Live audio capture: a :class:`LiveRingSource` fed by a device input
    callback, or ``None`` when no backend exists.

    ``backend_factory(source) -> backend|None`` is injectable the same way
    as :func:`open_output_stream`'s. The returned source carries the
    backend on ``.backend`` so ``close()``-ing the app can stop the device.
    """
    source = LiveRingSource(sample_rate, num_channels, block_size)

    def _sounddevice_input_backend(src):
        try:  # pragma: no cover - depends on optional host audio stack
            import sounddevice  # type: ignore

            def cb(indata, _frames, _time, _status):
                src.push_planar(np.asarray(indata, np.float32).T)

            dev = sounddevice.InputStream(
                samplerate=src.sample_rate,
                channels=src.num_channels,
                blocksize=src.block_size,
                dtype="float32",
                callback=cb,
            )
            dev.start()
            return dev
        except Exception:
            return None

    factory = backend_factory or _sounddevice_input_backend
    backend = factory(source)
    if backend is None:
        logger.info("no live audio input backend available")
        return None
    source.backend = backend
    return source
