"""ctypes bindings for the native host runtime, with NumPy paths
(counterpart of ``gccnmf_tpu/native/runtime.py``).

The realtime audio path is the one place in this framework where host code
sits on a hard deadline (32 ms per 512-sample block at 16 kHz — reference:
gccNMF/realtime/audioProcessor.py:118-122). The native tier provides the
deadline-critical pieces in C++ (``gccnmf_torch/native/src/gccnmf_rt.cpp``):
PCM conversion, a lock-free SPSC ring between the audio callback and the
thread that drives the device, host overlap-add, and block-time telemetry.
Every class here takes a NumPy path when no C++ toolchain is available, so
the package stays importable everywhere; :func:`available` says which path
runs.

Public surface: :func:`available`, :func:`pcm16_to_float`,
:func:`float_to_pcm16`, :func:`deinterleave_pcm16`,
:func:`interleave_pcm16`, :class:`SpscRing`, :class:`OverlapAdd`,
:class:`BlockTimes`.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from gccnmf_torch.native import build as _build

__all__ = [
    "available",
    "pcm16_to_float",
    "float_to_pcm16",
    "deinterleave_pcm16",
    "interleave_pcm16",
    "SpscRing",
    "OverlapAdd",
    "BlockTimes",
]

_lib = None
_lib_lock = threading.Lock()
_lib_tried = False

_f32p = ctypes.POINTER(ctypes.c_float)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)


def _load():
    """Build+load the shared library once; None if unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    with _lib_lock:
        if _lib_tried:
            return _lib
        path = _build.build()
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
                _declare(lib)
                if lib.gccnmf_rt_abi_version() != 2:
                    raise OSError("gccnmf_rt ABI version mismatch")
                _lib = lib
            except OSError as e:
                # corrupt/incompatible artifact: fall back to NumPy rather
                # than poisoning every consumer; a rebuild will repair it
                import logging

                logging.getLogger(__name__).warning(
                    "native runtime unusable (%s); using NumPy fallback", e
                )
        _lib_tried = True
    return _lib


def _declare(lib) -> None:
    i64, u64, i32 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32
    ptr = ctypes.c_void_p
    sig = {
        "gccnmf_pcm16_to_float": (None, [_i16p, _f32p, i64]),
        "gccnmf_float_to_pcm16": (None, [_f32p, _i16p, i64]),
        "gccnmf_pcm32_to_float": (None, [_i32p, _f32p, i64]),
        "gccnmf_float_to_pcm32": (None, [_f32p, _i32p, i64]),
        "gccnmf_deinterleave_pcm16": (None, [_i16p, _f32p, i64, i32]),
        "gccnmf_interleave_pcm16": (None, [_f32p, _i16p, i64, i32]),
        "gccnmf_ring_create": (ptr, [u64]),
        "gccnmf_ring_destroy": (None, [ptr]),
        "gccnmf_ring_capacity": (u64, [ptr]),
        "gccnmf_ring_readable": (u64, [ptr]),
        "gccnmf_ring_writable": (u64, [ptr]),
        "gccnmf_ring_write": (u64, [ptr, _f32p, u64]),
        "gccnmf_ring_read": (u64, [ptr, _f32p, u64]),
        "gccnmf_ring_peek": (u64, [ptr, _f32p, u64]),
        "gccnmf_ola_create": (ptr, [i32, i32, i32]),
        "gccnmf_ola_destroy": (None, [ptr]),
        "gccnmf_ola_add_block": (None, [ptr, _f32p, i32, i32, i32]),
        "gccnmf_ola_emit_block": (None, [ptr, _f32p]),
        "gccnmf_times_create": (ptr, [i64]),
        "gccnmf_times_destroy": (None, [ptr]),
        "gccnmf_times_record": (None, [ptr, ctypes.c_double]),
        "gccnmf_times_stats": (None, [ptr, _f64p]),
        "gccnmf_times_snapshot": (i64, [ptr, _f64p, i64]),
        "gccnmf_rt_abi_version": (i32, []),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def available() -> bool:
    """True when the compiled native runtime is loadable."""
    return _load() is not None


def _as_c(a: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


# --------------------------------------------------------------------------
# PCM conversion (reference: gccNMF/wavfile.py:57-131)
# --------------------------------------------------------------------------


def pcm16_to_float(pcm: np.ndarray) -> np.ndarray:
    """int16 PCM → float32 in [-1, 1)."""
    pcm = _as_c(pcm, np.int16)
    lib = _load()
    if lib is None:
        return (pcm.astype(np.float32) / 32768.0).astype(np.float32)
    out = np.empty(pcm.shape, np.float32)
    lib.gccnmf_pcm16_to_float(
        pcm.ctypes.data_as(_i16p), out.ctypes.data_as(_f32p), pcm.size
    )
    return out


def float_to_pcm16(x: np.ndarray) -> np.ndarray:
    """float32 → int16 PCM, the reference convention (wavfile.py float2pcm,
    same as utils.wav.float_to_pcm): scale by 2^15, clip, truncate."""
    x = _as_c(x, np.float32)
    lib = _load()
    if lib is None:
        return (x * 32768.0).clip(-32768, 32767).astype(np.int16)
    out = np.empty(x.shape, np.int16)
    lib.gccnmf_float_to_pcm16(
        x.ctypes.data_as(_f32p), out.ctypes.data_as(_i16p), x.size
    )
    return out


def deinterleave_pcm16(pcm: np.ndarray, channels: int) -> np.ndarray:
    """Interleaved int16 frames ``(n*channels,)`` → planar float32 ``(channels, n)``."""
    pcm = _as_c(pcm, np.int16).ravel()
    frames = pcm.size // channels
    lib = _load()
    if lib is None:
        planar = pcm[: frames * channels].reshape(frames, channels).T
        return (planar.astype(np.float32) / 32768.0).astype(np.float32)
    out = np.empty((channels, frames), np.float32)
    lib.gccnmf_deinterleave_pcm16(
        pcm.ctypes.data_as(_i16p), out.ctypes.data_as(_f32p), frames, channels
    )
    return out


def interleave_pcm16(x: np.ndarray) -> np.ndarray:
    """Planar float32 ``(channels, n)`` → interleaved int16 ``(n*channels,)``."""
    x = _as_c(x, np.float32)
    channels, frames = x.shape
    lib = _load()
    if lib is None:
        return (x * 32768.0).clip(-32768, 32767).T.ravel().astype(np.int16)
    out = np.empty(frames * channels, np.int16)
    lib.gccnmf_interleave_pcm16(
        x.ctypes.data_as(_f32p), out.ctypes.data_as(_i16p), frames, channels
    )
    return out


# --------------------------------------------------------------------------
# SPSC ring
# --------------------------------------------------------------------------


class SpscRing:
    """Lock-free single-producer/single-consumer float32 sample ring.

    Decouples the audio callback from the thread that drives the device,
    in place of the reference's shared-memory frame arrays + Event
    handshake (runRealtimeGCCNMF.py:68-72, audioProcessor.py:118-122).
    Takes a mutex-guarded NumPy ring without a native build.
    """

    def __init__(self, capacity: int):
        self._lib = _load()
        # Both backends expose the SAME usable capacity: the native ring
        # rounds its slot count to a power of two (usable = slots - 1), so
        # mirror that here and report the actual value — backpressure
        # thresholds must not depend on whether a C++ toolchain was found.
        slots = 1
        while slots < int(capacity) + 1:
            slots <<= 1
        self.capacity = slots - 1
        if self._lib is not None:
            self._h = self._lib.gccnmf_ring_create(int(capacity))
            if not self._h:  # pragma: no cover - allocation failure
                raise MemoryError("gccnmf_ring_create failed")
            assert int(self._lib.gccnmf_ring_capacity(self._h)) == self.capacity
        else:
            self._buf = np.zeros(self.capacity + 1, np.float32)
            self._head = 0
            self._tail = 0
            self._lock = threading.Lock()

    def __del__(self):  # pragma: no cover - interpreter teardown ordering
        try:
            if self._lib is not None and self._h:
                self._lib.gccnmf_ring_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def readable(self) -> int:
        if self._lib is not None:
            return int(self._lib.gccnmf_ring_readable(self._h))
        with self._lock:
            return (self._tail - self._head) % (self.capacity + 1)

    def writable(self) -> int:
        if self._lib is not None:
            return int(self._lib.gccnmf_ring_writable(self._h))
        return self.capacity - self.readable()

    def write(self, samples: np.ndarray) -> int:
        """Append up to len(samples); returns how many were accepted."""
        samples = _as_c(samples, np.float32).ravel()
        if self._lib is not None:
            return int(
                self._lib.gccnmf_ring_write(
                    self._h, samples.ctypes.data_as(_f32p), samples.size
                )
            )
        with self._lock:
            n = min(samples.size, self.capacity - (self._tail - self._head) % (self.capacity + 1))
            cap = self.capacity + 1
            idx = (self._tail + np.arange(n)) % cap
            self._buf[idx] = samples[:n]
            self._tail = (self._tail + n) % cap
            return n

    def read(self, n: int) -> np.ndarray:
        """Consume up to n samples; returns what was available."""
        if self._lib is not None:
            out = np.empty(n, np.float32)
            got = int(self._lib.gccnmf_ring_read(self._h, out.ctypes.data_as(_f32p), n))
            return out[:got]
        with self._lock:
            cap = self.capacity + 1
            avail = (self._tail - self._head) % cap
            got = min(n, avail)
            idx = (self._head + np.arange(got)) % cap
            out = self._buf[idx].copy()
            self._head = (self._head + got) % cap
            return out


# --------------------------------------------------------------------------
# Host overlap-add (reference: gccNMF/realtime/utils.py:72-118)
# --------------------------------------------------------------------------


class OverlapAdd:
    """Host-side OLA: accumulate windowed frames, emit at 2-block delay.

    ``add_block(frames)`` slides the output ring by one block and
    overlap-adds ``(channels, num_frames, frame_size)`` synthesis frames
    whose last frame ends flush at the ring's end, hop apart;
    ``emit_block()`` returns the reference's fixed-latency output slice
    ``buffer[-3B:-2B]`` (utils.py:116).
    """

    def __init__(self, channels: int, block_size: int, num_blocks: int = 8):
        self._lib = _load()
        self.channels = channels
        self.block_size = block_size
        self.num_blocks = num_blocks
        if self._lib is not None:
            self._h = self._lib.gccnmf_ola_create(channels, block_size, num_blocks)
            if not self._h:  # pragma: no cover
                raise MemoryError("gccnmf_ola_create failed")
        else:
            self._buf = np.zeros((channels, block_size * num_blocks), np.float32)

    def __del__(self):  # pragma: no cover
        try:
            if self._lib is not None and self._h:
                self._lib.gccnmf_ola_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def add_block(self, frames: np.ndarray, hop_size: int) -> None:
        frames = _as_c(frames, np.float32)
        channels, num_frames, frame_size = frames.shape
        assert channels == self.channels
        span = frame_size + (num_frames - 1) * hop_size
        if span > self.block_size * self.num_blocks:
            raise ValueError(
                f"frames span {span} samples, ring holds only "
                f"{self.block_size * self.num_blocks}"
            )
        if self._lib is not None:
            self._lib.gccnmf_ola_add_block(
                self._h, frames.ctypes.data_as(_f32p), num_frames, frame_size, hop_size
            )
            return
        total = self.block_size * self.num_blocks
        self._buf[:, : total - self.block_size] = self._buf[:, self.block_size :]
        self._buf[:, total - self.block_size :] = 0.0
        for f in range(num_frames):
            start = total - frame_size - (num_frames - 1 - f) * hop_size
            self._buf[:, start : start + frame_size] += frames[:, f]

    def emit_block(self) -> np.ndarray:
        out = np.empty((self.channels, self.block_size), np.float32)
        if self._lib is not None:
            self._lib.gccnmf_ola_emit_block(self._h, out.ctypes.data_as(_f32p))
            return out
        total = self.block_size * self.num_blocks
        out[:] = self._buf[:, total - 3 * self.block_size : total - 2 * self.block_size]
        return out


# --------------------------------------------------------------------------
# Block-time telemetry (reference: audioProcessor.py:98-102)
# --------------------------------------------------------------------------


class BlockTimes:
    """Rolling per-block duration stats: record() from the hot loop,
    stats() → (min, max, mean, count) from anywhere (tearing tolerated)."""

    def __init__(self, capacity: int = 256):
        self._lib = _load()
        self.capacity = capacity
        if self._lib is not None:
            self._h = self._lib.gccnmf_times_create(capacity)
            if not self._h:  # pragma: no cover
                raise MemoryError("gccnmf_times_create failed")
        else:
            self._values = np.zeros(capacity, np.float64)
            self._count = 0

    def __del__(self):  # pragma: no cover
        try:
            if self._lib is not None and self._h:
                self._lib.gccnmf_times_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def record(self, seconds: float) -> None:
        if self._lib is not None:
            self._lib.gccnmf_times_record(self._h, float(seconds))
            return
        self._values[self._count % self.capacity] = seconds
        self._count += 1

    def stats(self) -> tuple[float, float, float, int]:
        if self._lib is not None:
            out = np.empty(4, np.float64)
            self._lib.gccnmf_times_stats(self._h, out.ctypes.data_as(_f64p))
            return float(out[0]), float(out[1]), float(out[2]), int(out[3])
        held = min(self._count, self.capacity)
        if held == 0:
            return 0.0, 0.0, 0.0, 0
        v = self._values[:held]
        return float(v.min()), float(v.max()), float(v.mean()), held

    def snapshot(self) -> np.ndarray:
        """Copy of the held window (unordered; tearing-tolerated) — the
        raw samples behind stats(), for host-side percentile math."""
        if self._lib is not None:
            out = np.empty(self.capacity, np.float64)
            n = int(
                self._lib.gccnmf_times_snapshot(
                    self._h, out.ctypes.data_as(_f64p), self.capacity
                )
            )
            return out[:n].copy()
        held = min(self._count, self.capacity)
        return self._values[:held].copy()

    def percentiles(self, qs=(50.0, 99.0)) -> tuple[float, ...]:
        """Window percentiles in the recorded unit; zeros when empty."""
        window = self.snapshot()
        if window.size == 0:
            return tuple(0.0 for _ in qs)
        return tuple(float(np.percentile(window, q)) for q in qs)
