"""The float32 rDFT of the front-end as an FFT (``csrc/frontend.cu``
``fft_coherence_kernel`` on the Stockham passes of ``csrc/fft.cuh``), on
the CPU: the constants the host builds for it (``frontend_basis``'s
``window``, ``twiddle``, ``plan`` and ``conjugate``, in every mode), and a
torch emulation of the kernel's own algorithm (the windowed frames packed
two real samples a complex value for an even window, the Stockham passes
of ``fft_plan``'s radices over the same fp32 twiddle table, the unpacking
Y[k] = A[k] + e^{+2πik/win}·B[k], then ``put_bin``'s planes and guarded
coherence and the angular product) held against the plain GEMM version,
against ``torch.fft.rfft`` of the windowed frames and against JAX: its
Pallas front-end in interpret mode where the hop divides the window, its
XLA ``stft(method="fft")`` with the coherence and the angular spectrogram
where it does not. The kernel itself is held against the plain version on
the card, its coherence planes against the function in float64
(``test_torch_cuda.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gccnmf_tpu.ops import gcc as jgcc
from gccnmf_tpu.ops import stft as jstft
from gccnmf_tpu.ops import windows as jwin
from gccnmf_tpu.ops.frontend_pallas import stft_gcc_frontend_pallas
from gccnmf_torch.ops.frontend_cuda import (
    check_frontend_basis, fft_channels_apart, frontend_basis, stft_gcc_frontend_plain,
)
from gccnmf_torch.ops.stft import frame_signal
from gccnmf_torch.ops.synthesis_cuda import (
    FFT_MAX_SMEM, FFT_SMEM_TARGET, fft_plan, fft_row_len, fft_twiddles,
)
from gccnmf_torch.ops.windows import hann_symmetric

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

CSRC = Path(__file__).resolve().parent.parent / "gccnmf_torch" / "csrc"
# test_torch_synthesis_fft.py's windows: powers of two (32, 256, 1,024),
# radices 4, 2, 3 (48), 4, 5, 5, 5 (1,000), 4 and the generic 11 (88), the
# generic 97 alone (194), and odd windows, the full complex transform (45:
# 3, 3, 5; 49: 7, 7)
WINDOWS = [32, 48, 256, 1000, 1024, 45, 49, 88, 194]


def _fft_len(win):
    return win // 2 if win % 2 == 0 else win


def _stockham(z, plan, tw, tstep):
    """The passes of ``fft_pass`` over rows z (R, L) complex64: butterfly j
    (k = j mod ns) takes inputs z[j + q·m] times e^{2πi kq/(ns·r)} from the
    table, their r-point + sign DFT from the same table, and writes output
    q to (j − k)·r + k + q·ns."""
    n, ns = z.shape[-1], 1
    for r in plan:
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
    return z


def fft_spectrum_emulated(stereo, basis, hop):
    """(Re Y, Im Y), each (..., 2, T, F), as ``fft_coherence_kernel``
    computes them from the FFT's fields of ``basis``: Y = conj rfft of the
    windowed frames (rfft itself for an unconjugated basis)."""
    window, twiddle, plan, conjugate = basis[4:8]
    win = window.shape[0]
    n, f = _fft_len(win), win // 2 + 1
    tw = torch.complex(twiddle[:, 0], twiddle[:, 1])
    frames = frame_signal(stereo.to(torch.float32), win, hop) * window  # (..., 2, T, win)
    lead = frames.shape[:-1]
    rows = frames.reshape(-1, win)
    if win % 2 == 0:  # z[n] = y[2n] + i·y[2n+1]
        z = torch.complex(rows[:, 0::2].contiguous(), rows[:, 1::2].contiguous())
    else:
        z = torch.complex(rows, torch.zeros_like(rows))
    z = _stockham(z, plan.tolist(), tw, win // n)
    k = torch.arange(f)
    if win % 2 == 0:  # Z[L] ≡ Z[0]
        a = z[:, torch.where(k == n, 0, k)]
        c = z[:, torch.where(k == 0, 0, n - k)]
        av = torch.complex(0.5 * (a.real + c.real), 0.5 * (a.imag - c.imag))
        bv = torch.complex(0.5 * (a.imag + c.imag), 0.5 * (c.real - a.real))
        y = av + tw[k] * bv
    else:
        y = z[:, :f]
    if not conjugate:
        y = torch.conj(y)
    return y.real.reshape(*lead, f), y.imag.reshape(*lead, f)


def fft_frontend_emulated(stereo, basis, cos_m, sin_m, hop):
    """The six outputs of ``stft_gcc_frontend_cuda`` in float32 from the
    emulated spectrum: |X| and the guarded PHAT coherence as ``put_bin``
    forms them, then the angular product of the stored coherence."""
    re, im = fft_spectrum_emulated(stereo, basis, hop)
    mag = torch.sqrt(re * re + im * im)
    den = mag[..., 0, :, :] * mag[..., 1, :, :]
    inv = torch.where(den > 1e-30, 1.0 / torch.where(den > 1e-30, den, 1.0), 0.0)
    re0, re1, im0, im1 = re[..., 0, :, :], re[..., 1, :, :], im[..., 0, :, :], im[..., 1, :, :]
    cre = (re0 * re1 + im0 * im1) * inv
    cim = (im0 * re1 - re0 * im1) * inv
    return re, im, mag, cre, cim, cre @ cos_m + cim @ sin_m


def _problem(win, hop, t, batch, seed, d=12):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((batch, 2, win + hop * (t - 1))) * 0.1).astype(np.float32)
    x[0, :, :win] = 0.0  # a silent first frame: zero coherence, as guarded
    cos_m, sin_m = jgcc.steering_cos_sin(16000.0, win // 2 + 1, 1.0, d)
    return x, cos_m, sin_m


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("win", WINDOWS)
def test_fft_basis_fields(win):
    """In every mode the basis carries the FFT's constants: the window
    itself, the win-th roots of unity rounded once from float64, the radix
    plan of fft_plan (whose product is the transform's length) and the
    spectrum's sign; a bf16 basis carries the same ones beside its rows."""
    window = hann_symmetric(win)
    basis = frontend_basis(window)
    assert basis.rows is None and basis.steer is None
    assert torch.equal(basis.window, torch.as_tensor(window))
    assert basis.window.dtype == basis.twiddle.dtype == torch.float32
    assert torch.equal(basis.twiddle, torch.as_tensor(fft_twiddles(win)))
    assert basis.plan.dtype == torch.int32 and basis.plan.tolist() == fft_plan(win)
    assert int(np.prod(basis.plan.tolist())) == _fft_len(win)
    assert basis.conjugate is True and frontend_basis(window, False).conjugate is False
    cos_m, sin_m = (torch.as_tensor(m) for m in jgcc.steering_cos_sin(16000.0, win // 2 + 1,
                                                                       1.0, 8))
    b16 = frontend_basis(window, False, matmul_dtype="bfloat16", steering=(cos_m, sin_m))
    assert b16.rows is not None and b16.steer is not None and b16.conjugate is False
    for got, want in zip(b16[4:7], basis[4:7]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("conjugate", [True, False])
def test_emulated_fft_matches_plain_and_rfft(win, conjugate):
    """The kernel's algorithm in fp32, at a hop that does not divide the
    window, against the plain GEMM version in float32 (spec, |X| and the
    angular spectrogram within 1e-5 × max, the coherence within 1e-4 × max,
    the card's bar) and against the float64 ``rfft`` of the windowed frames
    (within 2e-6 × max: fp32 butterflies, O(ε·log win))."""
    hop = win // 3 + 1
    x, cos_np, sin_np = _problem(win, hop, 9, 2, seed=win)
    xt, cos_m, sin_m = (torch.from_numpy(a) for a in (x, cos_np, sin_np))
    basis = frontend_basis(hann_symmetric(win), conjugate)
    got = fft_frontend_emulated(xt, basis, cos_m, sin_m, hop)
    want = stft_gcc_frontend_plain(xt, basis, cos_m, sin_m, hop_size=hop,
                                   matmul_dtype="float32", plane_dtype="float32")
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert _rel(g, w) <= (1e-4 if i in (3, 4) else 1e-5), i
    assert not got[3][0, 0].any() and not got[4][0, 0].any()  # the silent frame
    frames = frame_signal(xt.double(), win, hop) * torch.as_tensor(hann_symmetric(win)).double()
    spec = torch.fft.rfft(frames, dim=-1)
    spec = torch.conj(spec) if conjugate else spec
    assert _rel(got[0], spec.real) <= 2e-6 and _rel(got[1], spec.imag) <= 2e-6
    assert _rel(got[2], spec.abs()) <= 2e-6


@pytest.mark.parametrize("win,hop,t,batch,tile", [
    (32, 8, 20, 1, 8),      # a power of two
    (48, 12, 29, 2, 8),     # radices 4, 2, 3; several time tiles
    (45, 9, 25, 1, 16),     # an odd window: the full complex transform
    (256, 64, 37, 2, 16),   # radices 4, 4, 4, 2
])
def test_emulated_fft_frontend_matches_pallas(win, hop, t, batch, tile):
    """Hop | window: the six outputs against ``stft_gcc_frontend_pallas`` in
    float32, interpret mode (its planes carry zero lanes past F): spec and
    |X| within 1e-5 × max, the angular spectrogram within 1e-4 × max, and
    the coherence within 1e-4 where both channels' |X| is at least a tenth
    of its largest, within the JAX suite's coherence bar (2e-3,
    test_frontend_pallas.py) on the quieter bins."""
    x, cos_m, sin_m = _problem(win, hop, t, batch, seed=t)
    window = jwin.hann_symmetric(win)
    want = stft_gcc_frontend_pallas(
        jnp.asarray(x), jnp.asarray(window), jnp.asarray(cos_m), jnp.asarray(sin_m),
        hop_size=hop, matmul_dtype="float32", tile_t=tile, interpret=True)
    f = win // 2 + 1
    want = [torch.from_numpy(np.array(w)[..., :f] if i < 5 else np.array(w))
            for i, w in enumerate(want)]
    got = fft_frontend_emulated(torch.from_numpy(x), frontend_basis(np.asarray(window)),
                                torch.from_numpy(cos_m), torch.from_numpy(sin_m), hop)
    for i in (0, 1, 2):
        assert got[i].shape == want[i].shape and _rel(got[i], want[i]) <= 1e-5
    assert _rel(got[5], want[5]) <= 1e-4
    mag = got[2]
    well = torch.minimum(mag[..., 0, :, :], mag[..., 1, :, :]) >= 0.1 * float(mag.max())
    assert well.float().mean() > 0.2
    for i in (3, 4):
        err = (got[i] - want[i]).abs()
        assert float(err[well].max()) <= 1e-4 and float(err.max()) <= 2e-3


@pytest.mark.parametrize("win,hop,t", [(1000, 300, 7), (194, 60, 11), (49, 10, 13),
                                       (88, 30, 12)])
def test_emulated_fft_frontend_matches_xla_stft(win, hop, t):
    """A hop that does not divide the window, which the Pallas front-end
    refuses: JAX's XLA ``stft(method="fft", conjugate=True)`` with the
    guarded coherence and the angular spectrogram, at the same bars."""
    x, cos_m, sin_m = _problem(win, hop, t, 2, seed=hop)
    window = jwin.hann_symmetric(win)
    spec = jstft.stft(jnp.asarray(x), window, hop, conjugate=True, method="fft")
    coh = jgcc.coherence(spec, guard_zeros=True)
    ang = jgcc.angular_spectrogram(coh, cos_m, sin_m)
    want = [np.real(spec), np.imag(spec), np.abs(spec), np.real(coh), np.imag(coh), ang]
    want = [torch.from_numpy(np.array(w)) for w in want]
    got = fft_frontend_emulated(torch.from_numpy(x), frontend_basis(np.asarray(window)),
                                torch.from_numpy(cos_m), torch.from_numpy(sin_m), hop)
    for i in (0, 1, 2):
        assert got[i].shape == want[i].shape and _rel(got[i], want[i]) <= 1e-5
    assert _rel(got[5], want[5]) <= 1e-4
    mag = got[2]
    well = torch.minimum(mag[..., 0, :, :], mag[..., 1, :, :]) >= 0.1 * float(mag.max())
    for i in (3, 4):
        err = (got[i] - want[i]).abs()
        assert float(err[well].max()) <= 1e-4 and float(err.max()) <= 2e-3


def test_check_frontend_basis_takes_each_modes_constants():
    """A float32 call gets the FFT's window, twiddles, radices and sign, a
    bf16 call the tensor-core rows and fold; a float32 call whose basis
    lacks the FFT's fields raises, as nothing falls back to the GEMM."""
    cos_m, sin_m = (torch.as_tensor(m) for m in jgcc.steering_cos_sin(16000.0, 25, 1.0, 8))
    basis = frontend_basis(hann_symmetric(48), False, matmul_dtype="bfloat16",
                           steering=(cos_m, sin_m))
    cpu = torch.device("cpu")
    fft, tc = check_frontend_basis(basis, False, 48, 25, 8, cpu)
    assert tc is None and fft[3] is False
    assert all(torch.equal(a, b) for a, b in zip(fft[:3], basis[4:7]))
    fft, tc = check_frontend_basis(basis, True, 48, 25, 8, cpu)
    assert fft is None and tc[0] is basis.rows and tc[1] is basis.steer
    with pytest.raises(ValueError, match="float32 needs the FFT's window"):
        check_frontend_basis(basis[:4], False, 48, 25, 8, cpu)


def test_check_frontend_basis_raises_for_a_window_past_shared_memory():
    """The FFT holds a transform's two rows in one block's shared memory: a
    window one past the synthesis's limit (29,052 even, 14,525 odd) raises
    before anything launches, and the limits themselves pass."""
    cpu, z = torch.device("cpu"), torch.zeros(1, 1)

    def fields(win):
        f = win // 2 + 1
        return (z.expand(win, f), z.expand(win, f), None, None, torch.zeros(win),
                torch.zeros(win, 2), torch.as_tensor(fft_plan(win), dtype=torch.int32), True), f

    for win, ok in ((29052, True), (29054, False), (14525, True), (14527, False)):
        assert (16 * fft_row_len(win) <= FFT_MAX_SMEM) == ok
        basis, f = fields(win)
        if ok:
            assert check_frontend_basis(basis, False, win, f, 8, cpu)[1] is None
        else:
            with pytest.raises(ValueError, match="too long for the float32 FFT"):
                check_frontend_basis(basis, False, win, f, 8, cpu)


def test_host_constants_match_the_header():
    """The host's shared-memory target and limit are the header's, so the
    wrapper allocates channel 0's scratch row exactly when the kernel
    transforms the channels one after the other: even windows from 2,558
    samples, odd ones from 1,279."""
    text = (CSRC / "fft.cuh").read_text()
    assert int(re.search(r"FFT_SMEM_TARGET = (\d+);", text).group(1)) == FFT_SMEM_TARGET
    assert int(re.search(r"FFT_MAX_SMEM = (\d+);", text).group(1)) == FFT_MAX_SMEM
    assert [fft_channels_apart(w) for w in (2556, 2558, 1277, 1279, 1024)] == [
        False, True, False, True, False]
