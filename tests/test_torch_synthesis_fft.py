"""The float32 iDFT of the syntheses as an FFT (``csrc/istft.cuh``
``fft_frames_kernel``), on the CPU: the constants the host builds for it
(``synthesis_basis``'s ``scale``, ``twiddle`` and ``plan``), and a torch
emulation of the kernel's own algorithm (the same packing, the same
Stockham passes of the same radices, the same fp32 twiddle table) held
against the plain GEMM version, against ``torch.fft.irfft`` and, through
the overlap-add, against JAX's Pallas syntheses in interpret mode. The
kernel itself is held against the plain version on the card
(``test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gccnmf_tpu.ops import windows as jwin
from gccnmf_tpu.ops.enhance_pallas import tf_synthesis_pallas
from gccnmf_tpu.ops.synthesis_pallas import masked_synthesis_pallas
from gccnmf_torch.ops.enhance_cuda import tf_synthesis_basis, wiener_spectra_plain
from gccnmf_torch.ops.stft import overlap_add
from gccnmf_torch.ops.synthesis_cuda import (
    FFT_MAX_SMEM, check_idft_basis, fft_plan, fft_row_len, idft_args, idft_frames_plain,
    masked_spectra_plain, synthesis_basis,
)
from gccnmf_torch.ops.windows import hann_symmetric

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

# powers of two (32, 256, 1,024), windows that are not (48: radices 4, 2, 3;
# 1,000: 4, 5, 5, 5; 88: 4 and the generic 11; 194: the generic 97 alone),
# and odd windows (45: the full 45-point transform, 3, 3, 5; 49: 7, 7)
WINDOWS = [32, 48, 256, 1000, 1024, 45, 49, 88, 194]


def _fft_len(win):
    return win // 2 if win % 2 == 0 else win


def fft_frames_emulated(xr, xi, basis):
    """Frames (..., T, win) of spectra (..., T, F) as ``fft_frames_kernel``
    computes them from the FFT's fields of ``basis`` (a synthesis basis or
    its fields as a tuple), in torch on the CPU: Y = conj X with the
    imaginary parts of DC (and Nyquist) dropped, packed into one L-point
    complex input a frame, the Stockham passes of the plan (input q of
    butterfly j times the table's twiddle, the R-point DFT from the same
    table, output q to (j − k)·R + k + q·ns), then window·gain/win on the
    store."""
    scale, twiddle, plan = basis[3:6]
    win = scale.shape[0]
    n, f = _fft_len(win), win // 2 + 1
    tstep = win // n
    tw = torch.complex(twiddle[:, 0], twiddle[:, 1])
    x = torch.complex(xr[..., :f].reshape(-1, f), xi[..., :f].reshape(-1, f))
    k = torch.arange(n)
    if win % 2 == 0:
        a, c = x[:, k], x[:, n - k]
        ai, ci = a.imag.clone(), c.imag.clone()
        ai[:, 0] = 0.0
        ci[:, 0] = 0.0
        ev = torch.complex(a.real + c.real, ci - ai)
        od = torch.complex(a.real - c.real, -ai - ci) * tw[k]
        z = torch.complex(ev.real - od.imag, ev.imag + od.real)
    else:
        z = torch.where(k < f, torch.conj(x[:, torch.clamp(k, max=f - 1)]),
                        x[:, torch.clamp(n - k, max=f - 1)])
        z[:, 0] = torch.complex(x[:, 0].real, torch.zeros_like(x[:, 0].real))
    ns = 1
    for r in plan.tolist():
        m = n // r
        step = (n // (ns * r)) * tstep
        j = torch.arange(m)
        kk = j % ns
        v = torch.stack([z[:, j + q * m] * tw[kk * q * step] for q in range(r)], dim=1)
        q = torch.arange(r)
        rot = tw[((q[:, None] * q[None, :]) % r) * m * tstep]  # e^{2πi qu/r}
        out = torch.einsum("qu,bum->bqm", rot, v)
        dst = torch.empty_like(z)
        for qq in range(r):
            dst[:, (j - kk) * r + kk + qq * ns] = out[:, qq]
        z, ns = dst, ns * r
    y = torch.stack([z.real, z.imag], dim=-1).reshape(-1, win) if win % 2 == 0 else z.real
    y = y * np.float32(1.0 / win) * scale
    return y.reshape(*xr.shape[:-1], win)


def _spectra(win, rows=37, seed=0):
    rng = np.random.default_rng(seed)
    f = win // 2 + 1
    xr = torch.as_tensor(rng.standard_normal((2, rows, f)), dtype=torch.float32)
    xi = torch.as_tensor(rng.standard_normal((2, rows, f)), dtype=torch.float32)
    return xr, xi


@pytest.mark.parametrize("win", WINDOWS)
def test_fft_basis_fields(win):
    """``scale`` is window·gain, the twiddles are the win-th roots of unity
    rounded once from float64, and the plan's radices (4s, a 2, 3s, 5s,
    then other primes) multiply out to the transform's length."""
    window = hann_symmetric(win)
    basis = synthesis_basis(window, 0.25, "float32")
    assert torch.equal(basis.scale, torch.as_tensor(window) * np.float32(0.25))
    assert basis.twiddle.shape == (win, 2) and basis.twiddle.dtype == torch.float32
    ang = 2.0 * np.pi * np.arange(win) / win
    exact = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    assert np.abs(basis.twiddle.numpy().astype(np.float64) - exact).max() <= 2.0 ** -24
    plan = basis.plan.tolist()
    assert basis.plan.dtype == torch.int32 and plan == fft_plan(win)
    assert int(np.prod(plan)) == _fft_len(win)
    small = [r for r in plan if r in (4, 2, 3, 5)]
    assert plan[: len(small)] == small and plan.count(2) <= 1
    assert all(r > 5 and all(r % d for d in range(2, r)) for r in plan[len(small):])
    assert fft_row_len(win) >= _fft_len(win) + 1 and fft_row_len(win) % 2 == 1
    # the bf16 mode carries the same FFT constants beside its rows
    b16 = synthesis_basis(window, 0.25, "bfloat16")
    assert b16.rows is not None and torch.equal(b16.twiddle, basis.twiddle)


def test_tf_synthesis_basis_appends_the_fft_fields():
    """``basis[1:]`` of the Wiener synthesis is the iDFT's basis, the new
    fields appended after ``rows``: ``basis[:2]``, ``basis[2]`` and the
    slices the plain versions read stay where they were."""
    rng = np.random.default_rng(3)
    w = rng.random((129, 8)).astype(np.float32) + 1e-3
    window = hann_symmetric(256)
    tb = tf_synthesis_basis(w, window, 0.5, "float32")
    sb = synthesis_basis(window, 0.5, "float32")
    assert tb._fields == ("wn", "a", "b_neg", "rows", "scale", "twiddle", "plan")
    assert sb._fields == ("a", "b_neg", "rows", "scale", "twiddle", "plan")
    for got, want in zip(tb[1:], sb):
        assert (got is None and want is None) or torch.equal(got, want)
    assert tb[2] is tb.b_neg and sb[2] is None


@pytest.mark.parametrize("win", WINDOWS)
def test_emulated_fft_matches_plain_and_irfft(win):
    """The kernel's algorithm in fp32 equals the plain GEMM frames within
    1e-5 × max, and the float64 ``irfft`` of conj X times window·gain."""
    xr, xi = _spectra(win, seed=win)
    xr[0, 3, 0] = 0.0  # a zero DC bin
    basis = synthesis_basis(hann_symmetric(win), 0.25, "float32")
    got = fft_frames_emulated(xr, xi, basis)
    plain = idft_frames_plain(xr, xi, basis, "float32")
    assert got.shape == plain.shape == (2, 37, win)
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    x = xr.double().numpy() - 1j * xi.double().numpy()
    want = np.fft.irfft(x, n=win) * basis.scale.double().numpy()
    ref = torch.fft.irfft(torch.complex(xr.double(), -xi.double()), n=win)
    assert np.allclose(ref.numpy(), np.fft.irfft(x, n=win))
    # fp32 butterflies: O(ε·log win) of the scale
    assert float(np.abs(got.double().numpy() - want).max()) <= 2e-6 * scale


def _synth_problem(t, f, k=6, seed=0, batch=1):
    rng = np.random.default_rng(seed)
    spec = (rng.standard_normal((batch, 2, t, f))
            + 1j * rng.standard_normal((batch, 2, t, f))).astype(np.complex64)
    spec[0, 0, 3, 5] = 0.0
    spec[0, 1, 7, 0] = 0.0
    w = (rng.random((batch, f, k)) + 0.05).astype(np.float32)
    h = (rng.random((batch, 2, t, k)) + 0.01).astype(np.float32)
    winner = rng.integers(0, 3, (batch, t, k)).astype(np.int32)
    return spec, w, h, winner


def _planes(spec):
    return torch.from_numpy(spec.real.copy()), torch.from_numpy(spec.imag.copy())


def _istft(frames, hop, t, win):
    return overlap_add(frames, hop)[..., win // 2 : win // 2 + (t - 1) * hop]


@pytest.mark.parametrize("win,t,batch,hop,tile,seed", [
    (32, 20, 1, 8, 8, 0),     # test_synthesis_pallas.py: matches_xla_path
    (32, 37, 2, 8, 4, 7),     # several tiles: the TPU carry crosses tiles
    (48, 29, 1, 12, 8, 1),    # a window of radices 4, 2, 3
    (45, 25, 2, 9, 8, 2),     # an odd window: the full complex transform
])
def test_emulated_fft_synthesis_matches_pallas(win, t, batch, hop, tile, seed):
    """The masked synthesis with the kernel's FFT for its iDFT (the plain
    spectra, the emulated frames, the overlap-add and center trim) against
    ``masked_synthesis_pallas`` in float32, interpret mode."""
    f = win // 2 + 1
    spec, w, h, winner = _synth_problem(t, f, seed=seed, batch=batch)
    window = jwin.hann_symmetric(win)
    want = np.asarray(masked_synthesis_pallas(
        jnp.asarray(spec), jnp.asarray(winner), jnp.asarray(w), jnp.asarray(h), window,
        num_targets=3, hop_size=hop, gain=0.25, matmul_dtype="float32", tile_t=tile,
        interpret=True))
    basis = synthesis_basis(np.asarray(window), 0.25, "float32")
    xr, xi = masked_spectra_plain(*_planes(spec), torch.from_numpy(winner), torch.from_numpy(w),
                                  torch.from_numpy(h), num_targets=3, matmul_dtype="float32")
    got = _istft(fft_frames_emulated(xr, xi, basis), hop, t, win)
    assert got.shape == want.shape
    # fp32 in another order (the GEMM there, butterflies here)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ratio", [4, 16])
def test_emulated_fft_tf_synthesis_matches_pallas(ratio):
    """The Wiener synthesis with the kernel's FFT for its iDFT against
    ``tf_synthesis_pallas`` in float32, interpret mode (window 256, T = 37
    over time tiles of 16, as test_torch_enhance.py)."""
    rng = np.random.default_rng(ratio)
    b, t, f, k = 2, 37, 129, 8
    spec = (rng.standard_normal((b, 2, t, f)) + 1j * rng.standard_normal((b, 2, t, f))
            ).astype(np.complex64)
    h_mask = rng.random((b, t, k)).astype(np.float32)
    w = rng.random((f, k)).astype(np.float32) + 1e-3
    window = jwin.hann_symmetric(256)
    hop = 256 // ratio
    want = np.asarray(tf_synthesis_pallas(
        jnp.asarray(spec), jnp.asarray(h_mask), w, window, hop_size=hop, gain=0.5,
        matmul_dtype="float32", tile_t=16, interpret=True))
    basis = tf_synthesis_basis(w, np.asarray(window), 0.5, "float32")
    xr, xi = wiener_spectra_plain(*_planes(spec), torch.from_numpy(h_mask), basis.wn, "float32")
    got = _istft(fft_frames_emulated(xr, xi, basis[1:]), hop, t, 256)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(want).max())


def test_check_idft_basis_takes_each_modes_constants():
    """A float32 call gets the FFT's scale, twiddles and radices (and the
    pass count as its launch argument), a bf16 call the tensor-core rows."""
    window = hann_symmetric(48)
    basis = synthesis_basis(window, 0.5, "bfloat16")
    cpu = torch.device("cpu")
    fft, rows = check_idft_basis("t", basis, False, 25, 48, cpu)
    assert rows is None and all(torch.equal(a, b) for a, b in zip(fft, basis[3:]))
    args = idft_args(fft, rows)
    assert args[3] == 3 and args[4] == 0 and all(a != 0 for a in args[:3])
    fft, rows = check_idft_basis("t", basis, True, 25, 48, cpu)
    assert fft is None and torch.equal(rows, basis.rows)
    assert idft_args(fft, rows)[:4] == (0, 0, 0, 0)


def test_check_idft_basis_raises_without_the_fft():
    """A float32 call whose basis lacks the FFT's constants raises: nothing
    falls back to a GEMM."""
    basis = synthesis_basis(hann_symmetric(32), 0.5, "float32")
    with pytest.raises(ValueError, match="t: .*FFT's scale"):
        check_idft_basis("t", basis[:3], False, 17, 32, torch.device("cpu"))


def test_check_idft_basis_raises_for_a_window_past_shared_memory():
    """The FFT holds a frame in one block's shared memory: a window whose two
    rows do not fit raises before anything launches."""
    win = 2 * (FFT_MAX_SMEM // 16)
    f = win // 2 + 1
    assert 16 * fft_row_len(win) > FFT_MAX_SMEM >= 16 * fft_row_len(win - 4)
    z = torch.zeros(1, 1)
    basis = (z.expand(f, win), z.expand(f, win), None, torch.zeros(win),
             torch.zeros(win, 2), torch.as_tensor(fft_plan(win), dtype=torch.int32))
    with pytest.raises(ValueError, match="too long for the float32 FFT"):
        check_idft_basis("t", basis, False, f, win, torch.device("cpu"))
