"""The plain versions of the synthesis and front-end kernels against the
Pallas kernels in interpret mode, on the CPU (the CUDA kernels themselves
are held against these plain versions in ``test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gccnmf_tpu.ops import gcc as jgcc
from gccnmf_tpu.ops import masks as jmasks
from gccnmf_tpu.ops import windows as jwin
from gccnmf_tpu.ops.frontend_pallas import stft_gcc_frontend_pallas
from gccnmf_tpu.ops.synthesis_pallas import masked_synthesis_pallas
from gccnmf_torch.convert import from_numpy_state
from gccnmf_torch.ops.frontend_cuda import (
    BIN_GROUP, PLANE_DTYPES, check_frontend_basis, frontend_basis, reads_signal, stft_gcc_frontend_cuda,
    stft_gcc_frontend_plain,
)
from gccnmf_torch.ops.nmf_cuda import row_pad
from gccnmf_torch.ops.stft import overlap_add
from gccnmf_torch.ops.synthesis_cuda import (
    idft_frames_plain, idft_rows, masked_spectra_plain, masked_synthesis_cuda,
    masked_synthesis_plain, synthesis_basis,
)
from gccnmf_torch.precision import round_bf16

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

SR, WIN, HOP, F, D = 16000.0, 1024, 128, 513, 128


def _synth_problem(t=20, f=17, k=6, seed=0, batch=1):
    """test_synthesis_pallas.py's problem: complex mixture with exact-zero
    bins (angle(0) == 0), random coherence, positive W and H."""
    rng = np.random.default_rng(seed)
    spec = (rng.standard_normal((batch, 2, t, f))
            + 1j * rng.standard_normal((batch, 2, t, f))).astype(np.complex64)
    spec[0, 0, 3, 5] = 0.0
    spec[0, 1, 7, 0] = 0.0
    coh = (rng.standard_normal((batch, t, f))
           + 1j * rng.standard_normal((batch, t, f))).astype(np.complex64)
    w = (rng.random((batch, f, k)) + 0.05).astype(np.float32)
    h = (rng.random((batch, 2, t, k)) + 0.01).astype(np.float32)
    cos_m, sin_m = jgcc.steering_cos_sin(16000.0, f, 1.0, 12)
    targets = np.tile(np.array([2, 5, 9], np.int32), (batch, 1))
    winner = np.array(jmasks.attribution_winner(
        jnp.asarray(coh), cos_m, sin_m, jnp.asarray(targets), jnp.asarray(w)))
    return spec, w, h, winner


def _planes(spec):
    return torch.from_numpy(spec.real.copy()), torch.from_numpy(spec.imag.copy())


class TestSynthesisPlain:
    @pytest.mark.parametrize("t,batch,hop,tile,seed", [
        (20, 1, 8, 8, 0),    # test_synthesis_pallas.py: matches_xla_path
        (37, 2, 8, 4, 7),    # several tiles: the TPU carry crosses tiles
        (40, 1, 2, 16, 0),   # window/hop = 16
    ])
    def test_float32_matches_pallas(self, t, batch, hop, tile, seed):
        spec, w, h, winner = _synth_problem(t=t, seed=seed, batch=batch)
        window = jwin.hann_symmetric(32)
        gain = 0.25
        want = np.asarray(masked_synthesis_pallas(
            jnp.asarray(spec), jnp.asarray(winner), jnp.asarray(w), jnp.asarray(h), window,
            num_targets=3, hop_size=hop, gain=gain, matmul_dtype="float32", tile_t=tile,
            interpret=True))
        st = from_numpy_state({"window": window})
        basis = synthesis_basis(st["window"].numpy(), gain)
        got = masked_synthesis_plain(
            *_planes(spec), torch.from_numpy(winner), torch.from_numpy(w),
            torch.from_numpy(h), basis, num_targets=3, hop_size=hop, matmul_dtype="float32")
        assert got.shape == want.shape
        # fp32 products in another summation order: rtol 1e-4 / atol 1e-5
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)

    def test_bfloat16_matches_pallas(self):
        spec, w, h, winner = _synth_problem(t=37, seed=2)
        window = jwin.hann_symmetric(32)
        want = np.asarray(masked_synthesis_pallas(
            jnp.asarray(spec), jnp.asarray(winner), jnp.asarray(w), jnp.asarray(h), window,
            num_targets=3, hop_size=8, gain=0.5, matmul_dtype="bfloat16", tile_t=8,
            interpret=True))
        got = masked_synthesis_plain(
            *_planes(spec), torch.from_numpy(winner), torch.from_numpy(w),
            torch.from_numpy(h), synthesis_basis(window, 0.5), num_targets=3, hop_size=8,
            matmul_dtype="bfloat16")
        # same bf16 rounding points; a product landing on the other side of
        # a bf16 rounding boundary moves it by one bf16 step (2^-8 relative)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-2 * np.abs(want).max())

    @pytest.mark.parametrize("window_size,t,hop", [(32, 37, 8), (256, 45, 64)])
    def test_tensor_core_layout_matches_plain_and_pallas(self, window_size, t, hop):
        """The bf16 iDFT's operands: the spectrum rows ``[Re X | Im X | 0]``
        of every (utterance, target, channel, frame) and the basis rows
        ``[A ; −B]``, on zero-padded 16-byte rows (2F = 34 or 258, not a
        multiple of 64; T ragged). One 2F-deep product over them, bf16
        operands summed in fp32, gives the plain frames, and through the
        overlap-add the plain output and masked_synthesis_pallas in bf16."""
        f = window_size // 2 + 1
        spec, w, h, winner = _synth_problem(t=t, f=f, seed=3, batch=2)
        window = jwin.hann_symmetric(window_size)
        basis = synthesis_basis(window, 0.5, "bfloat16")
        assert synthesis_basis(window, 0.5, "float32").rows is None
        args = (*_planes(spec), torch.from_numpy(winner), torch.from_numpy(w),
                torch.from_numpy(h))
        xr, xi = masked_spectra_plain(*args, num_targets=3, matmul_dtype="bfloat16")
        rows, j = idft_rows(xr, xi), -(-2 * f // 8) * 8
        assert rows.dtype == basis.rows.dtype == torch.bfloat16
        assert rows.shape == (2 * 3 * 2 * t, j) and basis.rows.shape == (window_size, j)
        bf = lambda x: x.reshape(-1, f).to(torch.bfloat16)  # noqa: E731
        assert torch.equal(rows[:, :f], bf(xr)) and torch.equal(rows[:, f : 2 * f], bf(xi))
        assert torch.equal(basis.rows[:, :f], basis.a.T.to(torch.bfloat16))
        assert torch.equal(basis.rows[:, f : 2 * f], basis.b_neg.T.to(torch.bfloat16))
        assert not rows[:, 2 * f :].any() and not basis.rows[:, 2 * f :].any()
        frames = round_bf16(rows.float() @ basis.rows.float().T).reshape(
            2, 3, 2, t, window_size)
        plain = idft_frames_plain(xr, xi, basis)
        # the fp32 sums run in another order, then one bf16 rounding: a
        # frame moves by at most one bf16 step (2^-8 relative) of the scale
        np.testing.assert_allclose(frames.numpy(), plain.numpy(),
                                   atol=8e-3 * float(plain.abs().max()))
        got = overlap_add(frames, hop)[..., window_size // 2 :][..., : (t - 1) * hop].numpy()
        kw = dict(num_targets=3, hop_size=hop, matmul_dtype="bfloat16")
        want = masked_synthesis_plain(*args, basis, **kw).numpy()
        np.testing.assert_allclose(got, want, atol=1e-2 * np.abs(want).max())
        want = np.asarray(masked_synthesis_pallas(
            jnp.asarray(spec), jnp.asarray(winner), jnp.asarray(w), jnp.asarray(h), window,
            gain=0.5, tile_t=16, interpret=True, **kw))
        np.testing.assert_allclose(got, want, atol=1e-2 * np.abs(want).max())

    def test_wrapper_takes_plain_version_on_cpu(self):
        spec, w, h, winner = _synth_problem()
        args = (*_planes(spec), torch.from_numpy(winner), torch.from_numpy(w),
                torch.from_numpy(h), synthesis_basis(jwin.hann_symmetric(32), 0.25))
        kw = dict(num_targets=3, hop_size=8, matmul_dtype="float32")
        before = masked_synthesis_cuda.launches
        got = masked_synthesis_cuda(*args, **kw)
        assert masked_synthesis_cuda.launches == before
        np.testing.assert_array_equal(got.numpy(), masked_synthesis_plain(*args, **kw).numpy())


def _signal(b=2, t_frames=77, seed=0):
    rng = np.random.default_rng(seed)
    n = WIN + HOP * (t_frames - 1)
    return (rng.standard_normal((b, 2, n)) * 0.1).astype(np.float32)


def _frontend_state():
    cos_m, sin_m = jgcc.steering_cos_sin(SR, F, 1.0, D)
    window = jwin.hann_symmetric(WIN)
    return window, cos_m, sin_m, from_numpy_state({"cos": cos_m, "sin": sin_m, "window": window})


class TestFrontendPlain:
    @pytest.mark.parametrize("conjugate", [True, False])
    def test_float32_matches_pallas(self, conjugate):
        x = _signal(t_frames=77 if conjugate else 32, b=2 if conjugate else 1)
        window, cos_m, sin_m, st = _frontend_state()
        want = stft_gcc_frontend_pallas(
            jnp.asarray(x), jnp.asarray(window), jnp.asarray(cos_m), jnp.asarray(sin_m),
            hop_size=HOP, conjugate=conjugate, matmul_dtype="float32", tile_t=32,
            interpret=True)
        got = stft_gcc_frontend_plain(
            torch.from_numpy(x), frontend_basis(st["window"].numpy(), conjugate), st["cos"],
            st["sin"], hop_size=HOP, matmul_dtype="float32", plane_dtype="float32")
        # equality on [..., :F]; the Pallas planes carry zero lanes past F.
        # 1024-term fp32 sums of O(0.1) samples: atol 1e-4
        for g, wnt in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt)[..., :F], atol=1e-4)
        # coherence is X0·conj(X1)/(|X0||X1|): the ~1e-5 fp32 error in X
        # moves it by up to 1e-5/min|X|, so it is held at 1e-4 where
        # min(|X0|, |X1|) >= 0.1 and at the JAX suite's own coherence bar
        # (2e-3, test_frontend_pallas.py:55) on the quieter bins
        well = (torch.minimum(got[2][..., 0, :, :], got[2][..., 1, :, :]) >= 0.1).numpy()
        assert well.mean() > 0.5
        for g, wnt in zip(got[3:5], want[3:5]):
            g, wnt = g.numpy(), np.asarray(wnt)[..., :F]
            np.testing.assert_allclose(g[well], wnt[well], atol=1e-4)
            np.testing.assert_allclose(g, wnt, atol=2e-3)
        # the angular spectrogram sums 2·513 coherence terms of magnitude ≤ 1
        np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                                   atol=1e-4 * float(jnp.max(jnp.abs(want[5]))))

    def test_bf16_planes_match_pallas(self):
        x = _signal(b=1, t_frames=40)
        window, cos_m, sin_m, st = _frontend_state()
        want = stft_gcc_frontend_pallas(
            jnp.asarray(x), jnp.asarray(window), jnp.asarray(cos_m), jnp.asarray(sin_m),
            hop_size=HOP, matmul_dtype="bfloat16", plane_dtype="bfloat16", tile_t=32,
            interpret=True)
        got = stft_gcc_frontend_plain(
            torch.from_numpy(x), frontend_basis(window), st["cos"], st["sin"], hop_size=HOP,
            matmul_dtype="bfloat16", plane_dtype="bfloat16")
        for i, (g, wnt) in enumerate(zip(got, want)):
            assert g.dtype == (torch.float32 if i == 5 else torch.bfloat16)
            wnt = np.asarray(jnp.asarray(wnt, jnp.float32))[..., : g.shape[-1]]
            # bf16 storage: one bf16 step (2^-8 relative) of the plane's scale
            np.testing.assert_allclose(g.float().numpy(), wnt,
                                       atol=8e-3 * (np.abs(wnt).max() + 1e-12))


def _tensor_core_frontend(x, basis, hop, plane_dtype):
    """The bf16 kernels' arithmetic on their own operands, in fp32: the
    frames read from the bf16 signal rows (B·2, row_pad(n)) with a row
    stride of hop (or from frame rows staged once, for a hop or window not
    a multiple of 8), times the interleaved basis rows, de-interleaved; the
    epilogue's planes and its coherence rows [Re c | Im c | 0]; the angular
    spectrogram as those rows times the steering fold. Returns the six
    outputs, the coherence rows and the frame operand."""
    b, _, n = x.shape
    win, f = basis.wcos.shape
    t = 1 + (n - win) // hop
    sig = torch.zeros((b * 2, row_pad(n)), dtype=torch.bfloat16)
    sig[:, :n] = x.reshape(b * 2, n)
    if reads_signal(hop, win):  # row t of channel r at sig[r, t·hop:], overlapping rows
        frames = sig.as_strided((b * 2, t, row_pad(win)), (sig.shape[1], hop, 1))
    else:
        frames = torch.zeros((b * 2, t, row_pad(win)), dtype=torch.bfloat16)
        frames[..., :win] = sig[:, :n].unfold(-1, win, hop)[:, :t]
    out = (frames.float() @ basis.rows.float().T).reshape(b, 2, t, -1, 2, BIN_GROUP)
    re, im = (out[..., h, :].reshape(b, 2, t, -1)[..., :f] for h in (0, 1))
    mag = torch.sqrt(re * re + im * im)
    den = mag[:, 0] * mag[:, 1]
    inv = torch.where(den > 1e-30, 1.0 / torch.where(den > 1e-30, den, 1.0), 0.0)
    cre = (re[:, 0] * re[:, 1] + im[:, 0] * im[:, 1]) * inv
    cim = (im[:, 0] * re[:, 1] - re[:, 0] * im[:, 1]) * inv
    crows = idft_rows(cre, cim)
    ang = (crows.float() @ basis.steer.float().T).reshape(b, t, -1)
    planes = tuple(p.to(plane_dtype) for p in (re, im, mag, cre, cim))
    return (*planes, ang), crows, frames


class TestFrontendTensorCoreLayout:
    @pytest.mark.parametrize("hop,t_frames,plane", [
        (128, 77, "bfloat16"),   # the signal read with ld = hop; ragged T, 9 bin groups
        (64, 40, "float32"),     # bf16 products, fp32 planes
        (100, 40, "bfloat16"),   # hop not a multiple of 8: the frame-rows staging
    ])
    def test_layout_matches_plain_and_pallas(self, hop, t_frames, plane):
        """The operands of the bf16 kernels, turned back into the six
        outputs, give stft_gcc_frontend_plain and (hop | window)
        stft_gcc_frontend_pallas in interpret mode; every pad is zero."""
        rng = np.random.default_rng(11)
        x = (rng.standard_normal((2, 2, WIN + hop * (t_frames - 1))) * 0.1).astype(np.float32)
        window, cos_m, sin_m, st = _frontend_state()
        basis = frontend_basis(window, True, matmul_dtype="bfloat16",
                               steering=(st["cos"], st["sin"]))
        groups = -(-F // BIN_GROUP)
        assert basis.rows.shape == (2 * BIN_GROUP * groups, WIN)
        assert basis.steer.shape == (D, row_pad(2 * F))
        assert basis.rows.dtype == basis.steer.dtype == torch.bfloat16
        rows = basis.rows.reshape(groups, 2, BIN_GROUP, WIN)
        for h, m in enumerate((basis.wcos, basis.wsin)):
            half = rows[:, h].reshape(-1, WIN)
            assert torch.equal(half[:F], m.T.to(torch.bfloat16))
            assert not half[F:].any()  # bins past F: zero rows
        assert torch.equal(basis.steer[:, :F], st["cos"].T.to(torch.bfloat16))
        assert torch.equal(basis.steer[:, F : 2 * F], st["sin"].T.to(torch.bfloat16))
        assert not basis.steer[:, 2 * F :].any()
        xt = torch.from_numpy(x)
        got, crows, frames = _tensor_core_frontend(xt, basis, hop, PLANE_DTYPES[plane])
        assert reads_signal(hop, WIN) == (hop % 8 == 0)
        # every frame the kernel reads is the bf16 frame of the plain version
        assert torch.equal(frames[..., :WIN].reshape(2, 2, t_frames, WIN),
                           xt.unfold(-1, WIN, hop).to(torch.bfloat16))
        assert crows.shape == (2 * t_frames, row_pad(2 * F)) and not crows[:, 2 * F :].any()
        kw = dict(hop_size=hop, matmul_dtype="bfloat16", plane_dtype=plane)
        want = stft_gcc_frontend_plain(xt, basis, st["cos"], st["sin"], **kw)
        # the same bf16 operands summed in fp32 in another order; bf16
        # planes: one bf16 step (8e-3) of each plane's scale
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            w = w.float()
            np.testing.assert_allclose(g.float().numpy(), w.numpy(),
                                       atol=8e-3 * float(w.abs().max()))
        if WIN % hop:
            return
        pallas = stft_gcc_frontend_pallas(
            jnp.asarray(x), jnp.asarray(window), jnp.asarray(cos_m), jnp.asarray(sin_m),
            hop_size=hop, matmul_dtype="bfloat16", plane_dtype=plane, tile_t=32,
            interpret=True)
        for g, w in zip(got, pallas):
            w = np.asarray(jnp.asarray(w, jnp.float32))[..., : g.shape[-1]]
            np.testing.assert_allclose(g.float().numpy(), w,
                                       atol=8e-3 * (np.abs(w).max() + 1e-12))

    def test_bf16_needs_the_rows_and_the_fold(self):
        """A bf16 call needs the tensor-core operands: a basis built for
        float32 (or for other steering planes) is refused, and no bf16 basis
        is built without steering planes."""
        window, _, _, st = _frontend_state()
        with pytest.raises(ValueError, match="steering"):
            frontend_basis(window, matmul_dtype="bfloat16")
        fp32 = frontend_basis(window)
        assert fp32.rows is None and fp32.steer is None
        # float32 takes the FFT's constants, and no tensor-core operand
        fft, tc = check_frontend_basis(fp32, False, WIN, F, D, torch.device("cpu"))
        assert tc is None and fft[0] is fp32.window and fft[2] is fp32.plan and fft[3] is True
        bf16 = frontend_basis(window, matmul_dtype="bfloat16", steering=(st["cos"], st["sin"]))
        cpu = torch.device("cpu")
        for basis, d in ((fp32, D), (bf16[:2], D), (bf16, D - 1)):
            with pytest.raises(ValueError, match="frontend_basis"):
                check_frontend_basis(basis, True, WIN, F, d, cpu)
        fft, (rows, steer) = check_frontend_basis(bf16, True, WIN, F, D, cpu)
        assert fft is None and rows is bf16.rows and steer is bf16.steer

    def test_wrapper_takes_plain_version_on_cpu(self):
        x = torch.from_numpy(_signal(b=1, t_frames=9))
        window, _, _, st = _frontend_state()
        basis = frontend_basis(window, matmul_dtype="bfloat16", steering=(st["cos"], st["sin"]))
        args = (x, basis, st["cos"], st["sin"])
        before = stft_gcc_frontend_cuda.launches
        got = stft_gcc_frontend_cuda(*args, hop_size=HOP)
        assert stft_gcc_frontend_cuda.launches == before
        for g, w in zip(got, stft_gcc_frontend_plain(*args, hop_size=HOP)):
            assert torch.equal(g, w)


def test_jax_planes_pass_through_unchanged():
    """The planes the Pallas front-end emits (F padded to 640 with zeros)
    are valid synthesis input for the port: the extra lanes are ignored."""
    spec, w, h, winner = _synth_problem(t=12, seed=4)
    pad = np.zeros((1, 2, 12, 24), np.complex64)
    pad[..., :17] = spec
    basis = synthesis_basis(jwin.hann_symmetric(32), 0.25)
    args = (torch.from_numpy(winner), torch.from_numpy(w), torch.from_numpy(h), basis)
    kw = dict(num_targets=3, hop_size=8, matmul_dtype="float32")
    a = masked_synthesis_plain(*_planes(spec), *args, **kw)
    b = masked_synthesis_plain(*_planes(pad), *args, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert jax.default_backend() == "cpu"
