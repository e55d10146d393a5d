"""Host-side WAV I/O and PCM <-> float conversion.

The port's own copy of ``gccnmf_tpu/utils/wav.py`` (the port imports
nothing from the JAX package). Matches the reference's numeric conventions
so waveform parity holds end to end (reference: gccNMF/wavfile.py):

- PCM -> float: ``(x - offset) / 2^(bits-1)`` with ``offset = min + 2^(bits-1)``
  (wavfile.py:86-89), i.e. int16 maps to [-1, 1).
- float -> PCM: scale by ``2^(bits-1)``, clip to the integer range
  (wavfile.py:128-131). No dithering.
- clip protection on write: if max |x| >= 1, rescale to 0.99 with a warning
  (wavfile.py:32,40-44).

Channel convention: ``read_wav`` returns ``(channels, n)`` float32.
"""

from __future__ import annotations

import logging
import os

import numpy as np
from scipy.io import wavfile as _sp_wavfile

logger = logging.getLogger(__name__)

CLIP_PROTECTION_MAX = 0.99

__all__ = [
    "pcm_to_float",
    "float_to_pcm",
    "read_wav",
    "write_wav",
    "default_output_prefix",
    "WavReader",
    "StreamingWavWriter",
]


def default_output_prefix(mixture_path: str) -> str:
    """Root for ``<prefix>_sim_<n>.wav`` output naming: strip a ``_mix.wav``
    suffix, else the extension (reference getSourceEstimateFileName,
    gccNMF/gccNMFFunctions.py:43-45). One definition for every separation
    entry point so the naming convention cannot drift between them."""
    if mixture_path.endswith("_mix.wav"):
        return mixture_path[: -len("_mix.wav")]
    # splitext, NOT rsplit('.'): an extension-less file inside a dotted
    # directory (/data.v2/mix) must not be split at the directory's dot
    return os.path.splitext(mixture_path)[0]


def _to_float32(pcm: np.ndarray) -> np.ndarray:
    """PCM payload → float32 samples (float WAVs pass through)."""
    if pcm.dtype.kind == "f":
        return pcm.astype(np.float32)
    return pcm_to_float(pcm)


def pcm_to_float(sig: np.ndarray, dtype="float32") -> np.ndarray:
    """Integer PCM -> float in [-1, 1)."""
    sig = np.asarray(sig)
    if sig.dtype.kind not in "iu":
        raise TypeError("pcm_to_float expects an integer array")
    info = np.iinfo(sig.dtype)
    half_range = 2 ** (info.bits - 1)
    offset = info.min + half_range
    return (sig.astype(dtype) - offset) / half_range


def float_to_pcm(sig: np.ndarray, dtype="int16") -> np.ndarray:
    """Float in [-1, 1) -> integer PCM, clipped to the target range."""
    sig = np.asarray(sig)
    if sig.dtype.kind != "f":
        raise TypeError("float_to_pcm expects a float array")
    info = np.iinfo(np.dtype(dtype))
    half_range = 2 ** (info.bits - 1)
    offset = info.min + half_range
    return (sig * half_range + offset).clip(info.min, info.max).astype(dtype)


def _diagnose_read_error(path: str, err: Exception) -> Exception:
    """Map scipy's internal failures to an actionable message.

    A truncated payload surfaces as a reshape error deep inside scipy
    ("cannot reshape array of size N into shape (C)") — name the actual
    problem and the file instead."""
    if "reshape" in str(err):
        return ValueError(
            f"truncated or corrupt WAV (payload is not a whole number of "
            f"frames): {path}"
        )
    return type(err)(f"{err} (while reading {path})")


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> ``((channels, n) float32, sample_rate)``."""
    try:
        sample_rate, pcm = _sp_wavfile.read(path)
    except ValueError as e:
        raise _diagnose_read_error(path, e) from e
    return _to_float32(pcm).T, sample_rate


class WavReader:
    """Random-access WAV reader for hour-scale files.

    Memory-maps the PCM payload (``scipy.io.wavfile.read(mmap=True)``) so
    opening an hour-long recording costs O(1) RAM; each :meth:`read`
    converts only the requested sample range to float32. This is the input
    side of the chunked long-audio path — the reference always loads whole
    files (gccNMF/wavfile.py:34-37)."""

    def __init__(self, path: str):
        self.path = path
        try:
            self.sample_rate, pcm = _sp_wavfile.read(path, mmap=True)
        except ValueError as e:
            if "reshape" in str(e):
                raise _diagnose_read_error(path, e) from e
            # scipy cannot mmap non-power-of-two sample widths (24-bit
            # PCM); fall back to an in-memory read — range reads still
            # convert lazily, only the RAM bound degrades to O(file)
            logger.warning(
                "WavReader: %s cannot be memory-mapped, reading into RAM",
                path,
            )
            try:
                self.sample_rate, pcm = _sp_wavfile.read(path)
            except ValueError as e2:
                raise _diagnose_read_error(path, e2) from e2
        self._pcm = pcm
        self.num_samples = int(pcm.shape[0])
        self.num_channels = 1 if pcm.ndim == 1 else int(pcm.shape[1])

    def read(self, start: int, count: int) -> np.ndarray:
        """``(channels, count)`` float32 starting at sample ``start``.

        Ranges past the end are zero-padded (callers tile fixed-size
        chunks; the final one may overhang the file)."""
        start = max(int(start), 0)
        end = min(start + int(count), self.num_samples)
        samples = _to_float32(np.asarray(self._pcm[start:end]))
        samples = samples.T if samples.ndim == 2 else samples[None]
        if samples.shape[-1] < count:
            pad = np.zeros(
                (samples.shape[0], count - samples.shape[-1]), np.float32
            )
            samples = np.concatenate([samples, pad], axis=-1)
        return samples

    @property
    def raw_dtype(self) -> np.dtype:
        """Native dtype of the PCM payload (int16 for standard WAVs)."""
        return self._pcm.dtype

    def read_raw(self, start: int, count: int) -> np.ndarray:
        """``(channels, count)`` in the file's native PCM dtype,
        zero-padded past EOF — half the transfer bytes of :meth:`read`
        for int16 files when the float conversion runs on the device."""
        start = max(int(start), 0)
        end = min(start + int(count), self.num_samples)
        samples = np.asarray(self._pcm[start:end])
        samples = samples.T if samples.ndim == 2 else samples[None]
        samples = np.ascontiguousarray(samples)
        if samples.shape[-1] < count:
            pad = np.zeros(
                (samples.shape[0], count - samples.shape[-1]), samples.dtype
            )
            samples = np.concatenate([samples, pad], axis=-1)
        return samples


class StreamingWavWriter:
    """Incremental 16-bit PCM WAV writer (stdlib ``wave``).

    Appends ``(channels, n)`` float32 blocks as they arrive — O(block)
    RAM, unlike :func:`write_wav`/``WavSink`` which buffer the whole
    signal. Because the data is gone once written, clip protection is
    per-sample clipping (counted and warned on close) instead of the
    reference's whole-file rescale (gccNMF/wavfile.py:40-44) — a
    documented divergence for the streamed path only."""

    def __init__(self, path: str, sample_rate: int, num_channels: int = 2):
        import wave

        self.path = path
        self._wf = wave.open(path, "wb")
        self._wf.setnchannels(num_channels)
        self._wf.setsampwidth(2)
        self._wf.setframerate(int(sample_rate))
        self.num_channels = num_channels
        self.clipped_samples = 0
        self.samples_written = 0

    def write(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float32)
        if samples.ndim == 1:
            samples = samples[None]
        if samples.shape[0] != self.num_channels:
            raise ValueError(
                f"expected {self.num_channels} channels, got {samples.shape[0]}"
            )
        over = np.abs(samples) >= 1.0
        if over.any():
            self.clipped_samples += int(over.sum())
            samples = np.clip(samples, -1.0, 1.0 - 2.0**-15)
        pcm = float_to_pcm(samples).T  # (n, C) interleaved frame order
        self._wf.writeframes(np.ascontiguousarray(pcm).tobytes())
        self.samples_written += samples.shape[-1]

    def write_pcm(self, pcm: np.ndarray, clipped: int = 0) -> None:
        """Append already-converted ``(channels, n)`` int16 PCM (the
        device-side conversion path — half the transfer bytes).
        ``clipped`` folds a device-counted clip tally into the close()
        warning."""
        pcm = np.asarray(pcm)
        if pcm.dtype != np.int16:
            raise TypeError("write_pcm expects int16 PCM")
        if pcm.ndim == 1:
            pcm = pcm[None]
        if pcm.shape[0] != self.num_channels:
            raise ValueError(
                f"expected {self.num_channels} channels, got {pcm.shape[0]}"
            )
        self._wf.writeframes(np.ascontiguousarray(pcm.T).tobytes())
        self.clipped_samples += int(clipped)
        self.samples_written += pcm.shape[-1]

    def close(self) -> str:
        self._wf.close()
        if self.clipped_samples:
            logger.warning(
                "StreamingWavWriter: clipped %d samples in %s",
                self.clipped_samples,
                self.path,
            )
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_wav(
    samples: np.ndarray, path: str, sample_rate: int, clip_protection: bool = True
) -> None:
    """Write ``(channels, n)`` float32 samples to 16-bit PCM WAV."""
    samples = np.asarray(samples)
    max_abs = np.max(np.abs(samples)) if samples.size else 0.0
    if max_abs >= 1.0:
        if not clip_protection:
            raise ValueError("write_wav: max abs sample value exceeds 1")
        logger.warning(
            "write_wav: max abs sample %.3f exceeds 1, rescaling to %.2f",
            max_abs,
            CLIP_PROTECTION_MAX,
        )
        samples = samples / max_abs * CLIP_PROTECTION_MAX
    _sp_wavfile.write(path, sample_rate, float_to_pcm(samples.astype(np.float32)).T)
