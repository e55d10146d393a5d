"""Seeded synthetic audio for the cells: talkers at distinct delays between
two microphones, made on the device in a few large calls and returned as
int16 PCM, as users' WAV files hold it.

A talker is voiced speech in outline: a harmonic series (up to the Nyquist
rate) on a fundamental that jumps every syllable (100–300 Hz), under an
on/off syllable envelope (about 60 % of syllables voiced), with a breath
of noise 30 dB down. Talkers reach the second microphone ``delay``
samples after the first (an integer delay inside the array's largest
TDOA). Every seed gives the same sizes; only the content changes.
"""

from __future__ import annotations

import math

import torch

SYLLABLE_S = 0.25
HARMONICS = 24


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number:
    folded to 63 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63 - 1))
    return g


def talkers(g: torch.Generator, count: int, n: int, sample_rate: int, device) -> torch.Tensor:
    """``count`` seeded talkers of ``n`` samples, (count, n) float32, unit
    peak scale."""
    syl = int(SYLLABLE_S * sample_rate)
    nsyl = -(-n // syl)
    f0 = 100.0 + 200.0 * torch.rand((count, nsyl), generator=g, device=device)
    voiced = (torch.rand((count, nsyl), generator=g, device=device) < 0.6).float()
    f0 = f0.repeat_interleave(syl, dim=1)[:, :n]
    # a raised-cosine ramp at each syllable edge keeps the envelope smooth
    env = voiced.repeat_interleave(syl, dim=1)[:, :n]
    ramp = torch.hann_window(int(0.04 * sample_rate), periodic=False, device=device)
    env = torch.nn.functional.conv1d(env[:, None], (ramp / ramp.sum())[None, None],
                                     padding=ramp.numel() // 2)[:, 0, :n]
    phase = torch.cumsum(2.0 * math.pi * f0 / sample_rate, dim=1)
    amps = 1.0 / torch.arange(1, HARMONICS + 1, device=device, dtype=torch.float32)
    tilt = 0.5 + torch.rand((count, 1), generator=g, device=device)
    y = torch.zeros((count, n), device=device)
    for h in range(1, HARMONICS + 1):
        alias = (h * f0 < sample_rate / 2).float()
        y += alias * amps[h - 1] ** tilt * torch.sin(h * phase)
    y = y * env + 0.03 * torch.randn((count, n), generator=g, device=device)
    return y / y.abs().amax(dim=1, keepdim=True).clamp(min=1e-6)


def stereo_mixtures(g: torch.Generator, batch: int, n: int, sample_rate: int,
                    delays: torch.Tensor, gains: torch.Tensor, device) -> torch.Tensor:
    """``batch`` stereo mixtures ``(batch, 2, n)`` int16: talker ``i`` of
    mixture ``b`` at gain ``gains[b, i]`` on the first microphone and
    ``delays[b, i]`` samples later on the second. The mixtures peak at half
    of full scale."""
    count = delays.shape[1]
    pad = int(delays.abs().max())
    src = talkers(g, batch * count, n + 2 * pad, sample_rate, device)
    src = src.reshape(batch, count, -1) * gains[..., None]
    left = src[..., pad:pad + n].sum(dim=1)
    idx = torch.arange(n, device=device) + pad
    right = torch.gather(src, 2, (idx[None, None, :] - delays[..., None]).expand(batch, count, n))
    mix = torch.stack([left, right.sum(dim=1)], dim=1)
    mix = 0.5 * mix / mix.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-6)
    return torch.round(mix * 32767.0).to(torch.int16)


def spread_delays(g: torch.Generator, batch: int, count: int, max_delay: int,
                  device) -> torch.Tensor:
    """Integer delays for ``count`` talkers in each of ``batch`` mixtures:
    evenly spaced over ±0.75 of ``max_delay``, in a seeded order, each
    jittered by up to a tenth of the spacing."""
    span = 0.75 * max_delay
    base = torch.linspace(-span, span, count, device=device)
    order = torch.argsort(torch.rand((batch, count), generator=g, device=device), dim=1)
    jitter = (torch.rand((batch, count), generator=g, device=device) - 0.5) * 0.2 * (
        2 * span / max(count - 1, 1))
    return torch.round(base[order] + jitter).to(torch.long)
