"""PESQ-class perceptual speech quality (ITU-T P.862 model, clean-room;
counterpart of ``gccnmf_tpu/pesq_p862.py``, NumPy only).

An independent NumPy implementation of the P.862 perceptual model: level
alignment, time alignment, Bark-spectrum auditory transform, partial
frequency and gain compensation, Zwicker loudness, asymmetric and
symmetric disturbance aggregation, and the P.862.1 / P.862.2 MOS-LQO
mappings.

**Scope.** This follows the published algorithm's structure; it is not the
ITU reference code, whose band edges, IRS filter coefficients and
conformance vectors are not redistributable, so bit-parity with
``pesq.exe`` is out of scope. Band edges come from the Zwicker Bark scale,
the receive characteristic is a bandpass approximation, and the model
constants are calibrated so that three degradation families (additive
noise over SNR, MNRU over Q, lowpass truncation) land where the P.862
literature puts them; the JAX package's ``tests/test_metrics.py`` pins the
calibration band by band, and the port's tests hold this copy equal to it.
Two deliberate deviations from the ITU constants are documented inline:
the partial frequency compensation is clipped to ±(3..7) dB instead of
±20 dB, and the asymmetry factor is two-sided. It is a consistent,
reproducible quality axis for this framework's pipelines; other tools
should be expected to differ by a few tenths of a MOS point.

Supported: 16 kHz ("wb", default) and 8 kHz ("nb") sample rates, mono or
multichannel (averaged) inputs, and any constant misalignment between
reference and degraded (recovered by the aligner).
"""

from __future__ import annotations

import numpy as np

__all__ = ["pesq"]

# model constants ------------------------------------------------------------

_P0 = 2e-5  # reference pressure (Pa) for dB SPL
_TARGET_LEVEL_DB_SPL = 79.0  # P.862 nominal active speech level
_ZWICKER_POWER = 0.23
_DEADZONE = 0.25
_ASYM_EXPONENT = 1.2
_ASYM_KILL_BELOW = 3.0
_ASYM_CAP = 12.0
_SPLIT_FRAMES = 20  # ~320 ms "split second" intervals at 50% frame overlap
_P_SPLIT = 6.0  # Lp inside a split
_P_TOTAL = 2.0  # Lp across splits
# loudness scale: calibrated (not the ITU Sl) so MOS-LQO of the three
# canonical degradation families — additive white noise (SNR sweep), MNRU
# multiplicative noise (P.810 Q sweep), and lowpass bandwidth truncation —
# all track published P.862 behavior simultaneously (pinned band by band in
# the JAX package's tests/test_metrics.py::TestPesqCurves).
_LOUDNESS_SCALE = 1.8
# partial-compensation clip: ITU P.862 allows ±20 dB of frequency-response
# compensation, which in this analytically-banded implementation absorbs
# steady noise floors (MNRU/additive noise read as "high-band boost") and
# bandwidth truncation (lowpass reads as "linear attenuation") almost
# entirely — measured MOS 4.3 at MNRU Q=5 and 4.4 at a 1 kHz lowpass
# before this change, against published ~1.5 / ~2. Limiting the
# compensation to ±(3..7) dB keeps genuine mild spectral tilts
# compensated while letting noise floors and missing bands register as
# disturbance. A deliberate, documented deviation from the ITU constants.
_COMP_CLIP = (0.2, 2.0)


def _bark(f: np.ndarray) -> np.ndarray:
    """Zwicker's Hz→Bark mapping (Zwicker & Terhardt 1980)."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _threshold_in_quiet_db(f: np.ndarray) -> np.ndarray:
    """Terhardt's absolute hearing threshold (dB SPL) at frequency f."""
    khz = np.maximum(np.asarray(f, np.float64), 20.0) / 1000.0
    return (
        3.64 * khz ** -0.8
        - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
        + 1e-3 * khz ** 4
    )


class _Config:
    def __init__(self, sample_rate: int):
        if sample_rate == 16000:
            self.frame = 512
            self.num_bands = 49
            self.fmax = 8000.0
        elif sample_rate == 8000:
            self.frame = 256
            self.num_bands = 42
            self.fmax = 4000.0
        else:
            raise ValueError(
                f"pesq supports 8 kHz and 16 kHz inputs, got {sample_rate}"
            )
        self.sample_rate = sample_rate
        self.hop = self.frame // 2
        self.window = 0.5 - 0.5 * np.cos(
            2.0 * np.pi * np.arange(self.frame) / self.frame
        )
        freqs = np.fft.rfftfreq(self.frame, 1.0 / sample_rate)
        # band edges uniform on the Bark axis from 50 Hz to Nyquist; every
        # FFT bin belongs to exactly one band
        z_edges = np.linspace(
            _bark(np.asarray(50.0)), _bark(np.asarray(self.fmax)),
            self.num_bands + 1,
        )
        z_bins = _bark(freqs)
        self.band_of_bin = np.clip(
            np.searchsorted(z_edges, z_bins, side="right") - 1,
            0, self.num_bands - 1,
        )
        self.band_of_bin[z_bins < z_edges[0]] = -1  # below-audio bins dropped
        self.width_bark = np.diff(z_edges)  # (num_bands,)
        centers_z = 0.5 * (z_edges[:-1] + z_edges[1:])
        # invert bark() for band-center Hz via interpolation on a dense grid
        grid = np.linspace(20.0, self.fmax, 8192)
        self.center_hz = np.interp(centers_z, _bark(grid), grid)
        tq = _threshold_in_quiet_db(self.center_hz)
        self.abs_thresh = (_P0 ** 2) * 10.0 ** (tq / 10.0)  # intensity units


def _mono(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    if x.ndim == 2:
        x = x.mean(axis=0)
    if x.ndim != 1:
        raise ValueError(f"expected (n,) or (channels, n) audio, got {x.shape}")
    return x - x.mean()


def _bandpass(x: np.ndarray, sample_rate: int, lo: float, hi: float) -> np.ndarray:
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / sample_rate)
    spec[(f < lo) | (f > hi)] = 0.0
    return np.fft.irfft(spec, n=len(x))


def _align(ref: np.ndarray, deg: np.ndarray, cfg: _Config):
    """Recover the constant delay of ``deg`` relative to ``ref``.

    Coarse: cross-correlation of per-frame log-energy envelopes (hop
    granularity). Fine: direct cross-correlation within ±hop samples.
    Returns both signals trimmed to their overlap.
    """
    hop = cfg.hop

    def envelope(x):
        n = max(len(x) // hop, 1)
        e = np.add.reduceat(x[: n * hop] ** 2, np.arange(0, n * hop, hop))
        return np.log10(e + 1e-12)

    er, ed = envelope(ref), envelope(deg)
    m = min(len(er), len(ed))
    er, ed = er[:m] - er[:m].mean(), ed[:m] - ed[:m].mean()
    xc = np.correlate(ed, er, mode="full")
    coarse = (int(np.argmax(xc)) - (m - 1)) * hop

    # fine search around the coarse delay, sample granularity — a residual
    # 1-2 sample shift reads as broadband high-frequency disturbance
    best_d, best_v = coarse, -np.inf
    for d in range(coarse - hop, coarse + hop + 1):
        if d >= 0:
            a, b = ref[: len(deg) - d], deg[d:]
        else:
            a, b = ref[-d:], deg[: len(ref) + d]
        n = min(len(a), len(b))
        if n < cfg.frame * 2:
            continue
        v = float(np.dot(a[:n], b[:n])) / (
            np.linalg.norm(a[:n]) * np.linalg.norm(b[:n]) + 1e-12
        )
        if v > best_v:
            best_v, best_d = v, d
    d = best_d
    if d >= 0:
        ref, deg = ref[: len(deg) - d], deg[d:]
    else:
        ref, deg = ref[-d:], deg[: len(ref) + d]
    n = min(len(ref), len(deg))
    return ref[:n], deg[:n]


def _level_align(x: np.ndarray, cfg: _Config) -> np.ndarray:
    """Scale to the nominal active speech level (band-limited RMS over
    active frames → 79 dB SPL), the P.862 level-alignment step."""
    bp = _bandpass(x, cfg.sample_rate, 300.0, 3400.0)
    hop = cfg.hop
    n = max(len(bp) // hop, 1)
    fe = np.add.reduceat(bp[: n * hop] ** 2, np.arange(0, n * hop, hop)) / hop
    active = fe > fe.max() * 1e-4  # 40 dB activity threshold
    rms = np.sqrt(fe[active].mean()) if active.any() else np.sqrt(fe.mean())
    target = _P0 * 10.0 ** (_TARGET_LEVEL_DB_SPL / 20.0)
    return x * (target / max(rms, 1e-12))


def _bark_spectra(x: np.ndarray, cfg: _Config) -> np.ndarray:
    """(num_frames, num_bands) mean in-band power ("pitch power density")."""
    nf = (len(x) - cfg.frame) // cfg.hop + 1
    if nf < _SPLIT_FRAMES:
        raise ValueError("signal too short for PESQ (need ≥ ~0.4 s)")
    idx = np.arange(cfg.frame)[None, :] + cfg.hop * np.arange(nf)[:, None]
    spec = np.fft.rfft(x[idx] * cfg.window, axis=-1)
    power = (np.abs(spec) ** 2) / (cfg.window.sum() ** 2 / 4.0)
    bands = np.zeros((nf, cfg.num_bands))
    counts = np.zeros(cfg.num_bands)
    for b in range(cfg.num_bands):
        sel = cfg.band_of_bin == b
        c = int(sel.sum())
        if c:
            bands[:, b] = power[:, sel].sum(axis=-1)
            counts[b] = c
    # mean density per band (empty high bands keep zero power)
    return bands / np.maximum(counts, 1.0)


def _audible_power(bands: np.ndarray, cfg: _Config, factor: float = 1.0):
    audible = np.where(bands > factor * cfg.abs_thresh, bands, 0.0)
    return audible.sum(axis=-1)


def _loudness(bands: np.ndarray, cfg: _Config) -> np.ndarray:
    """Zwicker intensity→loudness per band (P.862 perceptual transform)."""
    p0 = cfg.abs_thresh
    ratio = np.maximum(bands / p0, 0.0)
    loud = (
        _LOUDNESS_SCALE
        * (p0 / 0.5e-9) ** _ZWICKER_POWER
        * ((0.5 + 0.5 * ratio) ** _ZWICKER_POWER - 1.0)
    )
    return np.where(bands > p0, loud, 0.0)


def _lp(values: np.ndarray, p: float, weights: np.ndarray | None = None):
    if weights is None:
        weights = np.ones_like(values)
    wsum = weights.sum()
    if wsum <= 0:
        return 0.0
    return float((np.sum(weights * np.abs(values) ** p) / wsum) ** (1.0 / p))


def _time_aggregate(frame_d: np.ndarray) -> float:
    """L6 within ~320 ms splits, then L2 across splits (P.862 style)."""
    nf = len(frame_d)
    splits = [
        frame_d[s : s + _SPLIT_FRAMES] for s in range(0, nf, _SPLIT_FRAMES)
    ]
    per_split = np.asarray([_lp(s, _P_SPLIT) for s in splits if len(s)])
    return _lp(per_split, _P_TOTAL)


def pesq(
    reference: np.ndarray,
    degraded: np.ndarray,
    sample_rate: int = 16000,
    mode: str | None = None,
) -> float:
    """Perceptual speech-quality MOS-LQO of ``degraded`` vs ``reference``.

    ``mode``: ``"wb"`` (P.862.2 mapping, default at 16 kHz) or ``"nb"``
    (P.862.1 mapping, default at 8 kHz). Returns a score in ~[1.0, 4.64];
    higher is better. See the module docstring for scope/calibration notes.
    """
    if mode is None:
        mode = "wb" if sample_rate == 16000 else "nb"
    if mode not in ("wb", "nb"):
        raise ValueError(f"mode must be 'wb' or 'nb', got {mode!r}")
    cfg = _Config(sample_rate)

    ref = _mono(reference)
    deg = _mono(degraded)
    if mode == "nb":
        # IRS-receive-like band limitation for the narrowband model
        ref = _bandpass(ref, sample_rate, 300.0, 3100.0)
        deg = _bandpass(deg, sample_rate, 300.0, 3100.0)
    else:
        ref = _bandpass(ref, sample_rate, 100.0, cfg.fmax)
        deg = _bandpass(deg, sample_rate, 100.0, cfg.fmax)
    ref, deg = _align(ref, deg, cfg)
    ref = _level_align(ref, cfg)
    deg = _level_align(deg, cfg)

    bref = _bark_spectra(ref, cfg)  # (T, B)
    bdeg = _bark_spectra(deg, cfg)

    # --- partial frequency-response compensation (applied to reference) --
    speech_active = _audible_power(bref, cfg) > 1e2 * cfg.abs_thresh.mean()
    if not speech_active.any():
        speech_active = np.ones(len(bref), bool)
    avg_ref = bref[speech_active].mean(axis=0)
    avg_deg = bdeg[speech_active].mean(axis=0)
    band_ratio = np.clip(
        (avg_deg + 1e3 * cfg.abs_thresh) / (avg_ref + 1e3 * cfg.abs_thresh),
        *_COMP_CLIP,
    )
    bref_eq = bref * band_ratio[None, :]

    # --- short-term gain compensation (applied to degraded) --------------
    pow_ref = _audible_power(bref_eq, cfg) + 5e-6
    pow_deg = _audible_power(bdeg, cfg) + 5e-6
    gain = pow_ref / pow_deg
    smoothed = np.empty_like(gain)
    g = gain[0]
    for t in range(len(gain)):  # first-order recursive smoothing
        g = 0.8 * g + 0.2 * gain[t]
        smoothed[t] = min(max(g, 3e-4), 5.0)
    bdeg_eq = bdeg * smoothed[:, None]

    # --- loudness + disturbance ------------------------------------------
    lref = _loudness(bref_eq, cfg)
    ldeg = _loudness(bdeg_eq, cfg)
    d = ldeg - lref
    dead = _DEADZONE * np.minimum(ldeg, lref)
    d = np.sign(d) * np.maximum(np.abs(d) - dead, 0.0)

    # asymmetry factor. ITU's factor amplifies only ADDED components
    # (coding noise); omissions rely on the symmetric branch alone. With
    # this implementation's analytic band layout the symmetric branch
    # under-weighs missing bands (measured: a 1 kHz brickwall lowpass
    # scored 4.4 vs published ~2), so the factor here is two-sided — a
    # band the degradation emptied is amplified exactly like a band it
    # filled. Another deliberate, documented deviation, pinned by the
    # lowpass column of the curve artifact.
    h_add = (
        (bdeg_eq + 50.0 * cfg.abs_thresh) / (bref_eq + 50.0 * cfg.abs_thresh)
    ) ** _ASYM_EXPONENT
    h_omit = (
        (bref_eq + 50.0 * cfg.abs_thresh) / (bdeg_eq + 50.0 * cfg.abs_thresh)
    ) ** _ASYM_EXPONENT
    h = np.maximum(h_add, h_omit)
    h = np.where(h < _ASYM_KILL_BELOW, 0.0, np.minimum(h, _ASYM_CAP))

    wb = cfg.width_bark[None, :]
    d_sym = np.sqrt(np.sum((d ** 2) * wb, axis=-1) / wb.sum())
    d_asym = np.sum(np.abs(d) * h * wb, axis=-1) / wb.sum()

    # de-emphasize silent frames (low reference audible power)
    frame_w = 1.0 / (1.0 + pow_ref / (1e4 * cfg.abs_thresh.mean())) ** -0.04
    d_sym = np.minimum(d_sym * frame_w, 45.0)
    d_asym = np.minimum(d_asym * frame_w, 45.0)

    dist_sym = _time_aggregate(d_sym)
    dist_asym = _time_aggregate(d_asym)

    raw = 4.5 - 0.1 * dist_sym - 0.0309 * dist_asym
    if mode == "wb":
        # P.862.2 wideband MOS-LQO mapping
        return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
    # P.862.1 narrowband MOS-LQO mapping
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607)))
