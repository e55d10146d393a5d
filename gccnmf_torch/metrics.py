"""Separation and enhancement quality metrics (counterpart of
``gccnmf_tpu/metrics.py``).

- ``snr``: signal-to-noise ratio of an estimate against its reference, the
  waveform-parity number of the tests;
- ``si_sdr``: scale-invariant SDR (Le Roux et al. 2019);
- ``sdr``: SDR with a time-invariant scalar projection (equal to SI-SDR);
- ``permutation_invariant``: the best mean metric over source orders;
- ``bss_eval_sources``: BSS-Eval SDR/SIR/SAR with 512-tap distortion
  filters (Vincent et al. 2006);
- ``stoi``: short-time objective intelligibility (Taal et al. 2011);
- ``pesq``: the P.862-model MOS-LQO of ``pesq_p862``.

They score on the host in NumPy (SciPy imported inside the functions that
need it), as JAX's do. Every argument may be a NumPy array or a CPU or CUDA
tensor: a tensor is copied to the host at the boundary.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from gccnmf_torch import pesq_p862

__all__ = [
    "snr", "si_sdr", "sdr", "permutation_invariant", "stoi",
    "bss_eval_sources", "pesq",
]


def _host(x):
    """A tensor (on any device) as NumPy; anything else as it is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _flatten_channels(x: np.ndarray) -> np.ndarray:
    x = np.asarray(_host(x), np.float64)
    return x.reshape(-1)


def pesq(reference, degraded, sample_rate: int = 16000, mode: str | None = None) -> float:
    """:func:`gccnmf_torch.pesq_p862.pesq` of host copies of the inputs."""
    return pesq_p862.pesq(_host(reference), _host(degraded), sample_rate, mode)


def snr(reference: np.ndarray, estimate: np.ndarray, eps: float = 1e-12) -> float:
    """SNR (dB) of estimate against reference: 10 log10 ||ref||²/||ref−est||²."""
    ref = _flatten_channels(reference)
    est = _flatten_channels(estimate)
    noise = ref - est
    return float(10.0 * np.log10((np.sum(ref**2) + eps) / (np.sum(noise**2) + eps)))


def si_sdr(reference: np.ndarray, estimate: np.ndarray, eps: float = 1e-12) -> float:
    """Scale-invariant SDR (dB): project estimate onto reference first."""
    ref = _flatten_channels(reference)
    est = _flatten_channels(estimate)
    ref = ref - ref.mean()
    est = est - est.mean()
    alpha = np.dot(est, ref) / (np.dot(ref, ref) + eps)
    target = alpha * ref
    noise = est - target
    return float(
        10.0 * np.log10((np.sum(target**2) + eps) / (np.sum(noise**2) + eps))
    )


def sdr(reference: np.ndarray, estimate: np.ndarray, eps: float = 1e-12) -> float:
    """BSS-eval-style SDR with scalar (time-invariant, gain-only) allowed
    distortion: the target is the least-squares scalar projection of the
    estimate on the reference, everything else counts as error."""
    return si_sdr(reference, estimate, eps)  # scalar projection == SI-SDR


def permutation_invariant(
    references: np.ndarray, estimates: np.ndarray, metric=si_sdr
) -> tuple[float, tuple[int, ...]]:
    """Best mean metric over source permutations.

    ``references``/``estimates``: (num_sources, ...) waveforms. Returns
    (best mean metric, best permutation mapping estimate i → reference
    perm[i]).
    """
    references, estimates = _host(references), _host(estimates)
    n = references.shape[0]
    best, best_perm = -np.inf, tuple(range(n))
    for perm in itertools.permutations(range(n)):
        score = float(
            np.mean([metric(references[p], estimates[i]) for i, p in enumerate(perm)])
        )
        if score > best:
            best, best_perm = score, perm
    return best, best_perm


# ---------------------------------------------------------------------------
# BSS-Eval — Vincent, Gribonval & Févotte 2006 (the SiSEC standard)
# ---------------------------------------------------------------------------
#
# The SDR/SIR/SAR numbers in the reference's papers (and every SiSEC
# campaign the bundled dev WAVs come from) are BSS-Eval figures: the
# allowed distortion is a 512-tap time-invariant filter, and the error is
# decomposed into interference (explained by the OTHER sources' delayed
# spans) and artifacts (explained by nothing). The scalar-projection
# ``sdr`` above is a different, stricter quantity.


def _proj(sources_f: np.ndarray, est_f: np.ndarray, n_out: int, flen: int):
    """Least-squares projection of an estimate onto the span of delayed
    sources.

    ``sources_f``: (K, n_fft) rFFTs of the zero-padded candidate sources;
    ``est_f``: (n_fft,) rFFT of the zero-padded estimate. Returns the
    projected time signal of length ``n_out`` (= n + flen - 1). The normal
    equations use correlation Toeplitz blocks computed by FFT — the same
    formulation as the original BSS_EVAL toolbox / mir_eval.
    """
    from scipy.linalg import solve, toeplitz
    from scipy.signal import fftconvolve

    k = sources_f.shape[0]
    n_fft = 2 * (sources_f.shape[1] - 1)
    # source-source correlations → block-Toeplitz Gram matrix
    g = np.zeros((k * flen, k * flen))
    for i in range(k):
        for j in range(i, k):
            ssf = np.fft.irfft(sources_f[i] * np.conj(sources_f[j]), n=n_fft)
            blk = toeplitz(
                np.hstack((ssf[0], ssf[-1 : -flen : -1])), r=ssf[:flen]
            )
            g[i * flen : (i + 1) * flen, j * flen : (j + 1) * flen] = blk
            if i != j:
                g[j * flen : (j + 1) * flen, i * flen : (i + 1) * flen] = blk.T
    # source-estimate correlations → right-hand side
    d = np.zeros(k * flen)
    for i in range(k):
        sef = np.fft.irfft(sources_f[i] * np.conj(est_f), n=n_fft)
        d[i * flen : (i + 1) * flen] = np.hstack(
            (sef[0], sef[-1 : -flen : -1])
        )
    try:
        c = solve(g, d, assume_a="pos").reshape(k, flen)
    except np.linalg.LinAlgError:
        c, *_ = np.linalg.lstsq(g, d, rcond=None)
        c = c.reshape(k, flen)
    out = np.zeros(n_out)
    srcs_t = np.fft.irfft(sources_f, n=n_fft, axis=-1)
    for i in range(k):
        out += fftconvolve(c[i], srcs_t[i])[:n_out]
    return out


def bss_eval_sources(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    filter_length: int = 512,
    compute_permutation: bool = True,
):
    """BSS-Eval SDR/SIR/SAR with 512-tap allowed distortion filters.

    ``reference_sources`` / ``estimated_sources``: (num_sources, n) (or
    (num_sources, channels, n) — channels are concatenated) float
    waveforms. Returns ``(sdr, sir, sar, perm)`` arrays of length
    num_sources, where ``perm[j]`` is the reference assigned to estimate
    ``j`` (best mean-SIR permutation, the BSS_EVAL toolbox convention;
    identity when ``compute_permutation=False``).

    Definition (Vincent et al. 2006, eqs. 2-12): for estimate ``ŝ`` and
    target ``s_i``, ``s_target`` is the projection of ``ŝ`` onto the span
    of 512 delayed copies of ``s_i``; ``P_all`` the projection onto the
    span of ALL sources' delays; ``e_interf = P_all − s_target``;
    ``e_artif = ŝ − P_all``; SDR/SIR/SAR are the corresponding energy
    ratios in dB.
    """
    refs = np.asarray(_host(reference_sources), np.float64)
    ests = np.asarray(_host(estimated_sources), np.float64)
    if refs.ndim > 2:
        refs = refs.reshape(refs.shape[0], -1)
        ests = ests.reshape(ests.shape[0], -1)
    if refs.ndim == 1:
        refs, ests = refs[None], ests[None]
    # STFT pipelines legitimately emit slightly shorter waveforms
    # ((T-1)*hop vs n); evaluate on the common support
    n_common = min(refs.shape[-1], ests.shape[-1])
    refs = refs[..., :n_common]
    ests = ests[..., :n_common]
    nsrc, n = refs.shape
    flen = int(filter_length)
    n_out = n + flen - 1
    n_fft = 1 << int(np.ceil(np.log2(n + flen - 1)))
    refs_f = np.fft.rfft(refs, n=n_fft, axis=-1)
    ests_f = np.fft.rfft(ests, n=n_fft, axis=-1)

    eps = 1e-30
    sdr_m = np.empty((nsrc, nsrc))
    sir_m = np.empty((nsrc, nsrc))
    sar_m = np.empty((nsrc, nsrc))
    for j in range(nsrc):  # estimate j
        p_all = _proj(refs_f, ests_f[j], n_out, flen)
        est_pad = np.zeros(n_out)
        est_pad[:n] = ests[j]
        e_artif = est_pad - p_all
        for i in range(nsrc):  # candidate target i
            s_target = _proj(refs_f[i : i + 1], ests_f[j], n_out, flen)
            e_interf = p_all - s_target
            p_t = np.sum(s_target**2)
            sdr_m[j, i] = 10 * np.log10(
                (p_t + eps) / (np.sum((e_interf + e_artif) ** 2) + eps)
            )
            sir_m[j, i] = 10 * np.log10(
                (p_t + eps) / (np.sum(e_interf**2) + eps)
            )
            sar_m[j, i] = 10 * np.log10(
                (np.sum((s_target + e_interf) ** 2) + eps)
                / (np.sum(e_artif**2) + eps)
            )
    if compute_permutation and nsrc > 1:
        best, best_perm = -np.inf, tuple(range(nsrc))
        for perm in itertools.permutations(range(nsrc)):
            score = float(np.mean([sir_m[j, p] for j, p in enumerate(perm)]))
            if score > best:
                best, best_perm = score, perm
    else:
        best_perm = tuple(range(nsrc))
    idx = (np.arange(nsrc), np.asarray(best_perm))
    return (
        sdr_m[idx], sir_m[idx], sar_m[idx], np.asarray(best_perm)
    )


# ---------------------------------------------------------------------------
# STOI — Short-Time Objective Intelligibility (Taal et al. 2011)
# ---------------------------------------------------------------------------

_STOI_SR = 10000
_STOI_FRAME = 256
_STOI_FFT = 512
_STOI_HOP = 128
_STOI_NUM_BANDS = 15
_STOI_MIN_FREQ = 150.0
_STOI_SEG = 30  # analysis segment length in frames (384 ms at 10 kHz)
_STOI_BETA_DB = -15.0  # SDR clipping bound
_STOI_DYN_RANGE_DB = 40.0  # silent-frame removal threshold


def _stoi_resample(x: np.ndarray, sample_rate: int) -> np.ndarray:
    if sample_rate == _STOI_SR:
        return x
    from scipy.signal import resample_poly

    g = np.gcd(int(sample_rate), _STOI_SR)
    return resample_poly(x, _STOI_SR // g, int(sample_rate) // g)


def _stoi_frames(x: np.ndarray) -> np.ndarray:
    """Hann-windowed rFFT magnitudes, (num_frames, 257)."""
    n = (len(x) - _STOI_FRAME) // _STOI_HOP + 1
    if n < 1:
        raise ValueError("signal too short for STOI")
    idx = np.arange(_STOI_FRAME)[None, :] + _STOI_HOP * np.arange(n)[:, None]
    win = np.hanning(_STOI_FRAME + 2)[1:-1]
    return np.abs(np.fft.rfft(x[idx] * win, n=_STOI_FFT, axis=-1))


def _stoi_octave_bands() -> np.ndarray:
    """(15, 257) one-third-octave band matrix at 10 kHz / 512-point FFT."""
    freqs = np.linspace(0, _STOI_SR / 2, _STOI_FFT // 2 + 1)
    centers = _STOI_MIN_FREQ * 2.0 ** (np.arange(_STOI_NUM_BANDS) / 3.0)
    lo = centers * 2.0 ** (-1.0 / 6.0)
    hi = centers * 2.0 ** (1.0 / 6.0)
    bands = np.zeros((_STOI_NUM_BANDS, freqs.size))
    for b in range(_STOI_NUM_BANDS):
        bands[b] = (freqs >= lo[b]) & (freqs < hi[b])
    return bands


def _stoi_remove_silent(clean: np.ndarray, degraded: np.ndarray):
    """Drop frames whose clean energy is >40 dB below the loudest frame."""
    win = np.hanning(_STOI_FRAME + 2)[1:-1]
    n = (len(clean) - _STOI_FRAME) // _STOI_HOP + 1
    idx = np.arange(_STOI_FRAME)[None, :] + _STOI_HOP * np.arange(n)[:, None]
    energy_db = 20.0 * np.log10(
        np.linalg.norm(clean[idx] * win, axis=-1) / np.sqrt(_STOI_FRAME) + 1e-30
    )
    keep = energy_db >= energy_db.max() - _STOI_DYN_RANGE_DB
    if not np.any(keep):
        raise ValueError("no active speech frames found for STOI")

    def rebuild(x):
        frames = x[idx[keep]] * win
        out = np.zeros((keep.sum() - 1) * _STOI_HOP + _STOI_FRAME)
        norm = np.zeros_like(out)
        for f in range(keep.sum()):
            s = f * _STOI_HOP
            out[s : s + _STOI_FRAME] += frames[f] * win
            norm[s : s + _STOI_FRAME] += win * win
        return out / np.maximum(norm, 1e-12)

    return rebuild(clean), rebuild(degraded)


def stoi(
    clean: np.ndarray, degraded: np.ndarray, sample_rate: int = 16000
) -> float:
    """Short-Time Objective Intelligibility (Taal et al., ICASSP 2010 /
    IEEE TASL 2011), classic (non-extended) variant.

    Both signals are resampled to 10 kHz, silent clean frames are removed,
    both are decomposed into 15 one-third-octave band envelopes, and
    normalized+clipped 384 ms envelope segments are correlated. Returns a
    score in roughly [0, 1]; ~1 for perfectly intelligible. Accepts mono
    ``(n,)`` or multichannel ``(channels, n)`` (averaged).
    """
    clean = np.asarray(_host(clean), np.float64)
    degraded = np.asarray(_host(degraded), np.float64)
    if clean.shape != degraded.shape:
        raise ValueError("clean/degraded shape mismatch")
    if clean.ndim == 2:
        return float(
            np.mean(
                [stoi(c, d, sample_rate) for c, d in zip(clean, degraded)]
            )
        )
    clean = _stoi_resample(clean, sample_rate)
    degraded = _stoi_resample(degraded, sample_rate)
    clean, degraded = _stoi_remove_silent(clean, degraded)

    bands = _stoi_octave_bands()
    # (frames, bands) band envelopes: sqrt of in-band energy
    x = np.sqrt(np.maximum(_stoi_frames(clean) ** 2 @ bands.T, 1e-30))
    y = np.sqrt(np.maximum(_stoi_frames(degraded) ** 2 @ bands.T, 1e-30))
    if x.shape[0] < _STOI_SEG:
        raise ValueError("too few active frames for a 384 ms STOI segment")

    beta = 10.0 ** (-_STOI_BETA_DB / 20.0)
    scores = []
    for m in range(_STOI_SEG, x.shape[0] + 1):
        xs = x[m - _STOI_SEG : m]  # (30, bands)
        ys = y[m - _STOI_SEG : m]
        alpha = np.linalg.norm(xs, axis=0) / (np.linalg.norm(ys, axis=0) + 1e-30)
        ys_n = np.minimum(ys * alpha, xs * (1.0 + beta))  # normalize + clip
        xc = xs - xs.mean(axis=0)
        yc = ys_n - ys_n.mean(axis=0)
        denom = np.linalg.norm(xc, axis=0) * np.linalg.norm(yc, axis=0) + 1e-30
        scores.append(np.sum(xc * yc, axis=0) / denom)
    return float(np.mean(scores))
