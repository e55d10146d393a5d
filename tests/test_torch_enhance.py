"""Offline enhancement on the CPU: the port's mask functions, ``h_infer``,
the plain versions of the soft-mask and Wiener-synthesis kernels and
``GCCNMFEnhancer`` against the JAX package (Pallas in interpret mode), at
the shapes of test_enhance_pallas.py. The CUDA kernels themselves are held
against these plain versions in ``test_torch_cuda.py``."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gccnmf_tpu.models import offline as joffline
from gccnmf_tpu.ops import gcc as jgcc
from gccnmf_tpu.ops import masks as jmasks
from gccnmf_tpu.ops import nmf as jnmf
from gccnmf_tpu.ops import windows as jwin
from gccnmf_tpu.ops.enhance_pallas import soft_mask_pallas, tf_synthesis_pallas
from gccnmf_torch.models.offline import GCCNMFEnhancer, OfflineConfig
from gccnmf_torch.ops import masks, nmf
from gccnmf_torch.ops.enhance_cuda import (
    enhance_synthesis_cuda, soft_mask_basis, soft_mask_cuda, soft_mask_plain,
    tdoa_argmax_plain, tf_synthesis_basis, tf_synthesis_cuda, tf_synthesis_plain,
    wiener_spectra_plain,
)
from gccnmf_torch.ops.frontend_cuda import frontend_basis
from gccnmf_torch.ops.stft import overlap_add
from gccnmf_torch.ops.synthesis_cuda import idft_frames_plain, idft_rows
from gccnmf_torch.precision import round_bf16
from gccnmf_torch.ops.windows import hann_symmetric

torch.set_num_threads(1)  # Tier-1 runs several xdist workers


def _mask_problem(b=1, t=20, f=17, k=6, num_tdoas=12, seed=0):
    """test_enhance_pallas.py's problem: random coherence, positive W."""
    rng = np.random.default_rng(seed)
    coh = (rng.standard_normal((b, t, f)) + 1j * rng.standard_normal((b, t, f))).astype(
        np.complex64)
    w = (rng.random((f, k)) + 0.05).astype(np.float32)
    cos_m, sin_m = jgcc.steering_cos_sin(16000.0, f, 1.0, num_tdoas)
    return coh, w, cos_m, sin_m


def _planes(z):
    return torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy())


def _scores64(coh, w, cos_m, sin_m, bf16=False):
    """(B, T, D, K) scores in float64 from the (optionally bf16-rounded)
    planes and folded dictionary."""
    fold = [m.T[:, :, None] * w[None] for m in (cos_m, sin_m)]  # (D, F, K) fp32
    re, im = coh.real, coh.imag
    if bf16:
        r = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        fold, re, im = [r(x) for x in fold], r(re), r(im)
    return (np.einsum("btf,dfk->btdk", re.astype(np.float64), fold[0])
            + np.einsum("btf,dfk->btdk", im.astype(np.float64), fold[1]))


class TestMasks:
    def test_fold_and_argmax_tdoa_match_jax(self):
        coh, w, cos_m, sin_m = _mask_problem(b=2, t=9, seed=3)
        coh[1, 4] = np.nan  # a NaN frame: every score NaN, so TDOA 0
        cw, sw = masks.fold_steering_dictionary(cos_m, sin_m, torch.from_numpy(w))
        jcw, jsw = jmasks.fold_steering_dictionary(cos_m, sin_m, w)
        np.testing.assert_array_equal(cw.numpy(), np.asarray(jcw))
        np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
        got = masks.argmax_tdoa(*_planes(coh), cw, sw, 12)
        want = np.asarray(jmasks.argmax_tdoa(jnp.asarray(coh.real), jnp.asarray(coh.imag),
                                             jcw, jsw, 12))
        assert got.dtype == torch.int32 and got.shape == (2, 9, 6)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[1, 4] == 0).all()

    @pytest.mark.parametrize("eps,beta,floor", [(5.0, 2.0, 0.0), (3.0, 1.5, 0.1), (2.0, 0.5, 0.3)])
    def test_soft_and_boxcar_masks_match_jax(self, eps, beta, floor):
        arg = np.random.default_rng(1).integers(0, 16, (2, 7, 5)).astype(np.int32)
        target = np.array([3.0, 11.0], np.float32)[:, None, None]
        got = masks.soft_tdoa_coefficient_mask(torch.from_numpy(arg), torch.from_numpy(target),
                                               eps, beta, floor)
        want = jmasks.soft_tdoa_coefficient_mask(jnp.asarray(arg), jnp.asarray(target),
                                                 jnp.float32(eps), jnp.float32(beta),
                                                 jnp.float32(floor))
        # exp and ** from two libraries: a few fp32 ulps
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        box = masks.boxcar_tdoa_coefficient_mask(torch.from_numpy(arg), torch.from_numpy(target),
                                                 eps)
        np.testing.assert_array_equal(box.numpy(), np.asarray(
            jmasks.boxcar_tdoa_coefficient_mask(jnp.asarray(arg), jnp.asarray(target),
                                                jnp.float32(eps))))

    def test_wiener_masks_match_jax(self):
        rng = np.random.default_rng(2)
        w = (rng.random((17, 6)) + 0.05).astype(np.float32)
        h = rng.random((2, 9, 6)).astype(np.float32)
        h_mask = rng.random((2, 9, 6)).astype(np.float32)
        tw, th, tm = (torch.from_numpy(x) for x in (w, h, h_mask))
        np.testing.assert_allclose(masks.wiener_tf_mask(tw, tm).numpy(), np.asarray(
            jmasks.wiener_tf_mask(jnp.asarray(w), jnp.asarray(h_mask))), rtol=1e-6)
        np.testing.assert_allclose(masks.wiener_tf_mask_h(tw, th, tm).numpy(), np.asarray(
            jmasks.wiener_tf_mask_h(jnp.asarray(w), jnp.asarray(h), jnp.asarray(h_mask))),
            rtol=1e-6)


def test_h_infer_matches_jax_and_survives_silence():
    rng = np.random.default_rng(4)
    w = (rng.random((17, 6)) + 0.05).astype(np.float32)
    v = (rng.random((2, 12, 17)) * 2.0).astype(np.float32)
    v[1, 5] = 0.0  # an all-zero frame collapses H to 0, never to NaN
    h0 = np.ones((2, 12, 6), np.float32)
    got = nmf.h_infer(torch.from_numpy(v), torch.from_numpy(w), torch.from_numpy(h0), 10)
    want = np.asarray(jnmf.h_infer(jnp.asarray(v), jnp.asarray(w), jnp.asarray(h0), 10))
    assert torch.isfinite(got).all()
    assert (got[1, 5] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-30)


class TestSoftMaskPlain:
    KW = dict(b=2, t=37, f=17, k=6, num_tdoas=10)  # 37 frames span 3 tiles of 16
    TARGETS = np.array([2.0, 7.0], np.float32)
    EPS, BETA, FLOOR = 3.0, 1.5, 0.1

    def _pallas(self, coh, w, cos_m, sin_m, md):
        # D = 10 in chunks of 4: a zero-padded tail chunk
        return np.asarray(soft_mask_pallas(
            jnp.asarray(coh), w, cos_m, sin_m, jnp.asarray(self.TARGETS),
            jnp.float32(self.EPS), jnp.float32(self.BETA), jnp.float32(self.FLOOR),
            matmul_dtype=md, tile_t=16, chunk_d=4, batch_tile=2, interpret=True))

    def _plain(self, coh, w, cos_m, sin_m, md):
        # chunk_d 3 does not divide D either: the running max crosses chunks
        mask, arg = soft_mask_plain(
            *_planes(coh), soft_mask_basis(cos_m, sin_m, w, md), torch.from_numpy(self.TARGETS),
            self.EPS, self.BETA, self.FLOOR, matmul_dtype=md, chunk_d=3, return_argmax=True)
        return mask.numpy(), arg.numpy()

    def test_float32_matches_pallas(self):
        coh, w, cos_m, sin_m = _mask_problem(seed=1, **self.KW)
        s = np.sort(_scores64(coh, w, cos_m, sin_m), axis=2)
        gap = (s[:, :, -1] - s[:, :, -2]) / np.abs(s).max(axis=2)
        assert gap.min() > 1e-4  # no near-tie: every argmax is well defined
        mask, arg = self._plain(coh, w, cos_m, sin_m, "float32")
        cw, sw = jmasks.fold_steering_dictionary(cos_m, sin_m, w)
        want_arg = np.asarray(jmasks.argmax_tdoa(jnp.asarray(coh.real), jnp.asarray(coh.imag),
                                                 cw, sw, 10))
        np.testing.assert_array_equal(arg, want_arg)
        # the same argmax through exp/log of two libraries: within 2 fp32 ulps
        np.testing.assert_array_max_ulp(mask, self._pallas(coh, w, cos_m, sin_m, "float32"), 2)

    def test_bfloat16_agrees_with_pallas(self):
        coh, w, cos_m, sin_m = _mask_problem(seed=2, **self.KW)
        mask, arg = self._plain(coh, w, cos_m, sin_m, "bfloat16")
        want = self._pallas(coh, w, cos_m, sin_m, "bfloat16")
        # the argmax of bf16-rounded planes and folded product, and the mask
        # on (t, k) where the rounded scores leave no near-tie to fall the
        # other way
        ref_arg = np.argmax(_scores64(coh, w, cos_m, sin_m, bf16=True), axis=2)
        assert (arg == ref_arg).mean() >= 0.99
        assert np.isclose(mask, want, rtol=1e-6, atol=0).mean() >= 0.99

    def test_nan_frame_gives_tdoa_zero(self):
        coh, w, cos_m, sin_m = _mask_problem(seed=1, **self.KW)
        coh[0, 3] = np.nan
        mask, arg = self._plain(coh, w, cos_m, sin_m, "float32")
        assert (arg[0, 3] == 0).all()
        np.testing.assert_array_max_ulp(mask, self._pallas(coh, w, cos_m, sin_m, "float32"), 2)

    @pytest.mark.parametrize("f", [17, 41])  # 2F = 34 and 82: rows of 40 and 88
    def test_tensor_core_layout_matches_plain_and_jax(self, f):
        """The bf16 kernel's operands: coherence rows ``[Re c | Im c | 0]``
        and the fold ``[cw[d]; sw[d]]`` on 16-byte rows. One 2F-deep
        product per TDOA over them gives the argmax of tdoa_argmax_plain and
        of JAX's argmax_tdoa on the same bf16-rounded values, a NaN frame
        included."""
        kw = dict(self.KW, f=f)
        coh, w, cos_m, sin_m = _mask_problem(seed=5, **kw)
        b, t, k, d = kw["b"], kw["t"], kw["k"], kw["num_tdoas"]
        s = np.sort(_scores64(coh, w, cos_m, sin_m, bf16=True), axis=2)
        assert ((s[:, :, -1] - s[:, :, -2]) / np.abs(s).max()).min() > 1e-5  # no near-tie
        coh[1, 4] = np.nan
        re, im = _planes(coh)
        basis = soft_mask_basis(cos_m, sin_m, w, "bfloat16")
        assert soft_mask_basis(cos_m, sin_m, w, "float32").fold is None
        rows, fold = idft_rows(re, im, f), basis.fold
        j = -(-2 * f // 8) * 8
        assert rows.dtype == fold.dtype == torch.bfloat16
        assert rows.shape == (b * t, j) and fold.shape == (d, k, j)
        same = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        same(rows[:, :f], re.reshape(-1, f).to(torch.bfloat16))
        same(rows[:, f : 2 * f], im.reshape(-1, f).to(torch.bfloat16))
        assert torch.equal(fold[..., :f], basis.cw.transpose(1, 2))
        assert torch.equal(fold[..., f : 2 * f], basis.sw.transpose(1, 2))
        assert not rows[:, 2 * f :].any() and not fold[..., 2 * f :].any()
        scores = (rows.double() @ fold.double().reshape(d * k, j).T).reshape(b, t, d, k)
        got = torch.where(torch.isnan(scores), -torch.inf, scores).max(dim=2).indices
        _, plain = tdoa_argmax_plain(re, im, basis, matmul_dtype="bfloat16")
        r = lambda x: jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)
        jcw, jsw = jmasks.fold_steering_dictionary(cos_m, sin_m, w)
        want = np.asarray(jmasks.argmax_tdoa(r(coh.real), r(coh.imag), r(jcw), r(jsw), d))
        np.testing.assert_array_equal(got.numpy(), plain.reshape(b, t, k).numpy())
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[1, 4] == 0).all()

    def test_wrapper_takes_plain_version_on_cpu(self):
        coh, w, cos_m, sin_m = _mask_problem(b=2, seed=1)
        args = (*_planes(coh), soft_mask_basis(cos_m, sin_m, w, "float32"),
                torch.tensor([2, 7]), 3.0, 2.0, 0.0)
        before = soft_mask_cuda.launches
        got = soft_mask_cuda(*args, matmul_dtype="float32")
        assert soft_mask_cuda.launches == before
        assert torch.equal(got, soft_mask_plain(*args, matmul_dtype="float32"))


class TestTfSynthesisPlain:
    """tf_synthesis_plain against tf_synthesis_pallas (test_enhance_pallas.py
    TestTfSynthesis's problem: window 256, T = 37 over time tiles of 16)."""

    def _setup(self, b=2, t=37, f=129, k=8, seed=0):
        rng = np.random.default_rng(seed)
        spec = (rng.standard_normal((b, 2, t, f)) + 1j * rng.standard_normal((b, 2, t, f))
                ).astype(np.complex64)
        h_mask = rng.random((b, t, k)).astype(np.float32)
        w = rng.random((f, k)).astype(np.float32) + 1e-3
        return spec, h_mask, w, jwin.hann_symmetric(2 * (f - 1))

    @pytest.mark.parametrize("ratio", [4, 8, 16])
    def test_float32_matches_pallas(self, ratio):
        spec, h_mask, w, window = self._setup(seed=ratio)
        hop = window.shape[0] // ratio
        want = np.asarray(tf_synthesis_pallas(
            jnp.asarray(spec), jnp.asarray(h_mask), w, window, hop_size=hop, gain=0.5,
            matmul_dtype="float32", tile_t=16, interpret=True))
        got = tf_synthesis_plain(*_planes(spec), torch.from_numpy(h_mask),
                                 tf_synthesis_basis(w, window, 0.5), hop_size=hop,
                                 matmul_dtype="float32")
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(want).max())

    def test_bfloat16_planes_match_pallas(self):
        spec, h_mask, w, window = self._setup(seed=1)
        re, im = (torch.from_numpy(p).to(torch.bfloat16) for p in (spec.real, spec.imag))
        jplanes = tuple(jnp.asarray(p.float().numpy(), jnp.bfloat16) for p in (re, im))
        want = np.asarray(tf_synthesis_pallas(
            jplanes, jnp.asarray(h_mask), w, window, hop_size=32, gain=0.25,
            matmul_dtype="bfloat16", tile_t=16, interpret=True))
        got = tf_synthesis_plain(re, im, torch.from_numpy(h_mask),
                                 tf_synthesis_basis(w, window, 0.25), hop_size=32,
                                 matmul_dtype="bfloat16")
        # the same bf16 rounding points; a value on the other side of a
        # rounding boundary moves by one bf16 step (2^-8 relative)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-2 * np.abs(want).max())

    @pytest.mark.parametrize("f,hop", [(17, 8), (129, 32)])  # 2F = 34 and 258
    def test_tensor_core_layout_matches_plain_and_pallas(self, f, hop):
        """The bf16 iDFT's operands: the spectrum rows ``[Re X | Im X | 0]``
        of every (utterance, channel, frame), T = 37 ragged, and the basis
        rows ``[A ; −B]`` on zero-padded 16-byte rows. One 2F-deep product
        over them, bf16 operands summed in fp32, gives the plain frames, and
        through the overlap-add the plain output and tf_synthesis_pallas in
        bf16."""
        spec, h_mask, w, window = self._setup(f=f, seed=3)
        t = spec.shape[2]
        re, im = (torch.from_numpy(p).to(torch.bfloat16) for p in (spec.real, spec.imag))
        basis = tf_synthesis_basis(w, window, 0.25, "bfloat16")
        assert tf_synthesis_basis(w, window, 0.25, "float32").rows is None
        xr, xi = wiener_spectra_plain(re, im, torch.from_numpy(h_mask), basis.wn)
        rows, j = idft_rows(xr, xi), -(-2 * f // 8) * 8
        assert rows.shape == (2 * 2 * t, j) and basis.rows.shape == (window.shape[0], j)
        assert torch.equal(rows[:, f : 2 * f], xi.reshape(-1, f).to(torch.bfloat16))
        assert not rows[:, 2 * f :].any() and not basis.rows[:, 2 * f :].any()
        frames = round_bf16(rows.float() @ basis.rows.float().T).reshape(2, 2, t, -1)
        plain = idft_frames_plain(xr, xi, basis[1:])
        # fp32 sums in another order, then one bf16 rounding: one bf16 step
        np.testing.assert_allclose(frames.numpy(), plain.numpy(),
                                   atol=8e-3 * float(plain.abs().max()))
        win = window.shape[0]
        got = overlap_add(frames, hop)[..., win // 2 :][..., : (t - 1) * hop].numpy()
        want = tf_synthesis_plain(re, im, torch.from_numpy(h_mask), basis, hop_size=hop,
                                  matmul_dtype="bfloat16").numpy()
        np.testing.assert_allclose(got, want, atol=1e-2 * np.abs(want).max())
        jplanes = tuple(jnp.asarray(p.float().numpy(), jnp.bfloat16) for p in (re, im))
        want = np.asarray(tf_synthesis_pallas(
            jplanes, jnp.asarray(h_mask), w, window, hop_size=hop, gain=0.25,
            matmul_dtype="bfloat16", tile_t=16, interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-2 * np.abs(want).max())

    def test_wrapper_and_composite_take_plain_versions_on_cpu(self):
        spec, h_mask, w, window = self._setup(b=1, seed=2)
        basis = tf_synthesis_basis(w, window, 0.5)
        before = tf_synthesis_cuda.launches
        got = tf_synthesis_cuda(*_planes(spec), torch.from_numpy(h_mask), basis, hop_size=64,
                                matmul_dtype="float32")
        assert tf_synthesis_cuda.launches == before
        assert torch.equal(got, tf_synthesis_plain(*_planes(spec), torch.from_numpy(h_mask),
                                                   basis, hop_size=64, matmul_dtype="float32"))
        coh, _, cos_m, sin_m = _mask_problem(t=37, f=129, k=8, num_tdoas=12)
        mb = soft_mask_basis(cos_m, sin_m, w, "float32")
        kw = dict(hop_size=64, matmul_dtype="float32")
        fused = enhance_synthesis_cuda(*_planes(spec), *_planes(coh), mb, basis, 5, 3.0, 2.0,
                                       0.0, **kw)
        hm = soft_mask_plain(*_planes(coh), mb, 5, 3.0, 2.0, 0.0, matmul_dtype="float32")
        assert torch.equal(fused, tf_synthesis_plain(*_planes(spec), hm, basis, **kw))


def _enh_cfg(**kw):
    """test_enhance_pallas.py's enhancer config: window 256, hop 32,
    16 TDOAs, K = 8, 10 cm spacing, float32 numerics."""
    return dict(window_size=256, hop_size=32, num_tdoas=16, dictionary_size=8,
                mic_separation_m=0.1, nmf_matmul_dtype="float32", **kw)


@pytest.fixture(scope="module")
def enh_problem():
    rng = np.random.default_rng(11)
    src = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    stereo = np.stack([src[0] + src[1], np.roll(src[0], 3) + np.roll(src[1], -2)])
    w = rng.random((129, 8)).astype(np.float32) + 1e-3
    return stereo.astype(np.float32), w


class TestEnhancer:
    @pytest.mark.parametrize("num_h_updates", [0, 10])
    @pytest.mark.parametrize("tail", ["xla", "pallas"])
    def test_matches_jax(self, enh_problem, tail, num_h_updates):
        stereo, w = enh_problem
        want = joffline.GCCNMFEnhancer(
            w, joffline.OfflineConfig(**_enh_cfg(synthesis_backend=tail)),
            num_h_updates=num_h_updates).enhance(stereo)
        got = GCCNMFEnhancer(w, OfflineConfig(**_enh_cfg()), num_h_updates=num_h_updates,
                             device="cpu").enhance(stereo)
        for key in ("enhanced", "target_tdoa_index", "angular"):
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got["target_tdoa_index"], want["target_tdoa_index"])
        np.testing.assert_allclose(got["enhanced"], want["enhanced"], atol=2e-4)
        # 2·129 coherence terms of magnitude <= 1 per angular bin
        np.testing.assert_allclose(got["angular"], want["angular"], atol=1e-4 * 258)

    @pytest.mark.parametrize("num_h_updates", [0, 10])
    def test_conv_stft_matches_jax(self, enh_problem, num_h_updates):
        """``stft_method="conv"``, the enhancer's analysis and synthesis as
        one convolution each, at test_matches_jax's bars."""
        stereo, w = enh_problem
        kw = _enh_cfg(stft_method="conv")
        want = joffline.GCCNMFEnhancer(w, joffline.OfflineConfig(**kw),
                                       num_h_updates=num_h_updates).enhance(stereo)
        got = GCCNMFEnhancer(w, OfflineConfig(**kw), num_h_updates=num_h_updates,
                             device="cpu").enhance(stereo)
        np.testing.assert_array_equal(got["target_tdoa_index"], want["target_tdoa_index"])
        np.testing.assert_allclose(got["enhanced"], want["enhanced"], atol=2e-4)
        np.testing.assert_allclose(got["angular"], want["angular"], atol=1e-4 * 258)

    def test_h_updates_change_the_output(self, enh_problem):
        stereo, w = enh_problem
        base, with_h = (GCCNMFEnhancer(w, OfflineConfig(**_enh_cfg()), num_h_updates=n,
                                       device="cpu").enhance(stereo)["enhanced"] for n in (0, 10))
        assert not np.allclose(base, with_h, atol=1e-6)
        assert 0 < (with_h**2).sum() < (stereo**2).sum()

    @pytest.mark.parametrize("num_h_updates", [0, 10])
    def test_batch_matches_single(self, enh_problem, num_h_updates):
        stereo, w = enh_problem
        enh = GCCNMFEnhancer(w, OfflineConfig(**_enh_cfg()), num_h_updates=num_h_updates,
                             device="cpu")
        other = np.ascontiguousarray(0.5 * stereo[::-1])
        batch = enh.enhance(np.stack([stereo, other]))
        for i, x in enumerate((stereo, other)):
            one = enh.enhance(x)
            assert batch["target_tdoa_index"][i] == one["target_tdoa_index"]
            np.testing.assert_allclose(batch["enhanced"][i], one["enhanced"],
                                       atol=1e-5 * np.abs(one["enhanced"]).max())
        want = joffline.GCCNMFEnhancer(w, joffline.OfflineConfig(**_enh_cfg()),
                                       num_h_updates=num_h_updates).enhance(
            np.stack([stereo, other]))
        np.testing.assert_array_equal(batch["target_tdoa_index"], want["target_tdoa_index"])

    @pytest.mark.parametrize("num_h_updates,beta", [(0, 2.0), (10, 2.0), (10, 0.0)])
    def test_kernel_branch_through_the_plain_versions(self, enh_problem, num_h_updates, beta):
        """The enhancer's kernel branch (planes from the front-end, then
        without H updates the soft mask and the Wiener synthesis) run on the
        CPU, where each wrapper takes its plain version: the same result as
        the plain path and as the JAX enhancer's XLA tail. With H updates
        the branch leaves both kernels, as JAX does, so at β = 0 its mask
        takes 0**0 = 1 literally (exp(−1) at distance 0, where the soft-mask
        kernel pins 1)."""
        stereo, w = enh_problem
        cfg = OfflineConfig(**_enh_cfg())
        kw = dict(target_beta=beta, num_h_updates=num_h_updates)
        plain = GCCNMFEnhancer(w, cfg, device="cpu", **kw).enhance(stereo)
        jax_tail = joffline.GCCNMFEnhancer(
            w, joffline.OfflineConfig(**_enh_cfg(synthesis_backend="xla")), **kw).enhance(stereo)
        enh = GCCNMFEnhancer(w, cfg, device="cpu", **kw)
        window = hann_symmetric(256)
        enh._frontend_backend = enh._synthesis_backend = "cuda"
        enh._dft_basis = frontend_basis(window)
        enh._mask_basis = soft_mask_basis(enh._cos, enh._sin, enh.w, "float32")
        enh._tf_basis = tf_synthesis_basis(enh.w, window, 0.25, "float32")
        got = enh.enhance(stereo)
        for want in (plain, jax_tail):
            np.testing.assert_array_equal(got["target_tdoa_index"], want["target_tdoa_index"])
            np.testing.assert_allclose(got["enhanced"], want["enhanced"], atol=2e-4)

    def test_defaults_and_state_mirror_jax(self, enh_problem):
        ours = inspect.signature(GCCNMFEnhancer).parameters
        theirs = inspect.signature(joffline.GCCNMFEnhancer).parameters
        assert list(ours)[:-1] == list(theirs) and list(ours)[-1] == "device"
        for name in theirs:
            a, b = ours[name].default, theirs[name].default
            if name == "config":  # two OfflineConfig classes: compare fields
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, name
        _, w = enh_problem
        with pytest.raises(ValueError, match="frequency bins disagree"):
            GCCNMFEnhancer(w[:100], OfflineConfig(**_enh_cfg()), device="cpu")
        with pytest.raises(ValueError, match="CUDA kernel"):
            GCCNMFEnhancer(w, OfflineConfig(**_enh_cfg(synthesis_backend="cuda")), device="cpu")
