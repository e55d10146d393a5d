"""The port's streaming engine (``gccnmf_torch/models/realtime.py``) on the CPU:
the cases of tests/test_realtime.py (the NumPy oracle at its bars, step
against scan, the multi-stream batch, passthrough, localization, latency,
the asymmetric low-latency mode, H updates), then the port against the JAX
engine on the same seeded blocks, block by block, and the port's windows
and ``stream_state_from_numpy``. The captured CUDA graph is held against
the eager step in ``test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from gccnmf_tpu.models import realtime as jrt
from gccnmf_tpu.ops import windows as jwin
from gccnmf_torch.convert import stream_state_from_numpy
from gccnmf_torch.models.realtime import (
    TARGET_MODE_BOXCAR, RTGCCNMFProcessor, StreamConfig, StreamParams, StreamState,
    parse_target_mode,
)
from gccnmf_torch.ops import windows

import oracle

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

CPU = "cpu"


@pytest.fixture(scope="module")
def dictionary():
    g = np.random.default_rng(1234)
    return g.random((513, 64)).astype(np.float32) + 1e-3


@pytest.fixture(scope="module")
def rt_params():
    return StreamParams.default(target_tdoa_index=30.0, target_epsilon=5.0, target_beta=2.0,
                                noise_floor=0.0, localization_enabled=False, device=CPU)


def _proc(w, cfg=StreamConfig()):
    return RTGCCNMFProcessor(w, cfg, device=CPU)


def _mask_agreement(got, want) -> float:
    """Share of coefficient-mask entries equal to fp32 rounding (the soft
    mask's exp and pow differ by an ulp between torch and XLA)."""
    return float(np.isclose(got, want, rtol=1e-6, atol=1e-7).mean())


def _oracle_bars(got, want):
    """tests/test_realtime.py's parity bars: float32 against float64 FFTs
    flip a per-atom argmax at near-ties, so SNR > 25 dB and > 0.93 of the
    samples within 3e-4 x max."""
    assert got.shape == want.shape
    err = got - want
    snr = 10 * np.log10((want ** 2).sum() / max((err ** 2).sum(), 1e-30))
    assert snr > 25.0, f"stream parity SNR {snr:.1f} dB"
    tight = (np.abs(err) < 3e-4 * np.abs(want).max()).mean()
    assert tight > 0.93, f"only {tight:.3f} of samples tightly matched"


class TestRTParity:
    def test_stream_matches_reference_loop(self, stereo_signal, dictionary, rt_params):
        mix, sr = stereo_signal
        mix = mix[:, : 512 * 40]
        got = _proc(dictionary, StreamConfig(extra_delay_blocks=1)).enhance_signal(
            mix, rt_params)[0]
        want = oracle.rt_stream_ref(
            mix, dictionary, sr, 1024, 512, 512, 64, 0.1, 30.0, 5.0, 2.0, 0.0
        )
        _oracle_bars(got, want)

    def test_block_deadline_content(self, stereo_signal, dictionary, rt_params):
        """No extra delay emits one block earlier than the reference: lower
        latency, the same content."""
        mix, _ = stereo_signal
        mix = mix[:, : 512 * 24]
        fast = _proc(dictionary).enhance_signal(mix, rt_params)[0]
        slow = _proc(dictionary, StreamConfig(extra_delay_blocks=1)).enhance_signal(
            mix, rt_params)[0]
        np.testing.assert_allclose(slow[:, 512:], fast[:, :-512], atol=1e-5)
        assert np.abs(slow[:, :512]).max() == 0  # pure delay zeros


class TestRTEngine:
    def test_step_scan_equivalence(self, stereo_signal, dictionary, rt_params):
        mix, _ = stereo_signal
        proc = _proc(dictionary)
        blocks = torch.as_tensor(proc.blocks_from_signal(mix[:, : 512 * 10]))
        state = proc.init_state(1)
        outs = []
        for i in range(blocks.shape[0]):
            state, out, _ = proc.step(state, blocks[i], rt_params)
            outs.append(out.numpy())
        _, scanned = proc.scan_blocks(proc.init_state(1), blocks, rt_params)
        np.testing.assert_allclose(np.stack(outs), scanned.numpy(), atol=1e-6)

    def test_multi_stream_batch_independent(self, stereo_signal, dictionary, rt_params):
        mix, _ = stereo_signal
        mix = mix[:, : 512 * 12]
        proc = _proc(dictionary)
        single = proc.enhance_signal(mix, rt_params)[0]
        batch = proc.enhance_signal(
            np.stack([mix, 0.5 * mix, np.zeros_like(mix) + mix[:, ::-1]]), rt_params)
        np.testing.assert_allclose(batch[0], single, atol=1e-5)
        np.testing.assert_allclose(batch[1], 0.5 * single, atol=1e-5)

    def test_separation_disabled_passthrough(self, stereo_signal, dictionary):
        """With separation off the engine is an identity OLA chain (up to
        the sqrt-hamming^2 COLA constant), one block late."""
        mix, _ = stereo_signal
        mix = mix[:, : 512 * 20]
        params = StreamParams.default(separation_enabled=False, localization_enabled=False,
                                      device=CPU)
        out = _proc(dictionary).enhance_signal(mix, params)[0]
        w = np.sqrt(np.hamming(1024))
        cola = (w * w)[::512].sum()
        got = out[:, 512 * 4: 512 * 18]
        want = mix[:, 512 * 3: 512 * 17] * cola
        np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max())
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999

    def test_localization_tracks_target(self, dictionary):
        """A source off to one side pulls the localized TDOA from center."""
        sr, n, delay = 16000, 512 * 30, 4
        s = np.random.default_rng(7).standard_normal(n).astype(np.float32)
        mix = np.stack([s, np.roll(s, delay)])
        params = StreamParams.default(localization_enabled=True, localization_window=6,
                                      device=CPU)
        proc = _proc(dictionary)
        state, (_, tel) = proc.scan_blocks(proc.init_state(1), proc.blocks_from_signal(mix),
                                           params, True)
        final_idx = float(state.target_idx[0])
        max_tdoa = 0.1 / 340.29
        expect = (delay / sr + max_tdoa) / (2 * max_tdoa) * 63
        assert abs(final_idx - expect) <= 3.0
        assert tel["target_tdoa_index"].shape == (30, 1)

    def test_latency_property(self):
        assert StreamConfig().algorithmic_latency_s == (1024 - 512 + 512) / 16000
        assert StreamConfig(extra_delay_blocks=1).algorithmic_latency_s == \
            (1024 - 512 + 1024) / 16000


class TestAsymmetricLowLatency:
    def test_asymmetric_passthrough_reconstruction(self, stereo_signal, dictionary):
        """Separation off, asymmetric windows: the chain reconstructs the
        input (COLA-exact product windows), one block late."""
        mix, _ = stereo_signal
        cfg = StreamConfig(window_size=1024, hop_size=128, block_size=128,
                           analysis_window="asymmetric", synthesis_length=256)
        params = StreamParams.default(separation_enabled=False, localization_enabled=False,
                                      device=CPU)
        sig = mix[:, : 128 * 100]
        out = _proc(dictionary, cfg).enhance_signal(sig, params)[0]
        got = out[:, 128 + 2048: 128 * 90]
        want = sig[:, 2048: 128 * 90 - 128]
        scale = float(np.median(np.abs(got).sum(-1) / np.abs(want).sum(-1)))
        np.testing.assert_allclose(got, want * scale, atol=3e-2 * np.abs(want).max())
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999

    def test_asymmetric_latency_below_reference_floor(self):
        cfg = StreamConfig(window_size=1024, hop_size=32, block_size=32,
                           analysis_window="asymmetric", synthesis_length=64)
        assert cfg.algorithmic_latency_s < 0.064


class TestHUpdates:
    def test_h_updates_change_output(self, stereo_signal, dictionary, rt_params):
        mix, _ = stereo_signal
        mix = mix[:, : 512 * 10]
        base = _proc(dictionary).enhance_signal(mix, rt_params)[0]
        with_h = _proc(dictionary, StreamConfig(num_h_updates=5)).enhance_signal(
            mix, rt_params)[0]
        assert base.shape == with_h.shape
        assert not np.allclose(base, with_h, atol=1e-6)
        assert 0 < (with_h ** 2).sum() <= (mix ** 2).sum() * 1.5
        assert np.isfinite(with_h).all()

    def test_all_pass_mask_cancels_h(self, stereo_signal, dictionary):
        """A boxcar passing every TDOA makes the H-aware Wiener mask
        W·H/(W·H+ε) ≈ 1: the output matches the W-only all-pass path."""
        mix, _ = stereo_signal
        mix = mix[:, : 512 * 8]
        params = StreamParams.default(target_tdoa_index=32.0, target_epsilon=1e6,
                                      localization_enabled=False, device=CPU)
        want = _proc(dictionary, StreamConfig(target_mode=TARGET_MODE_BOXCAR)).enhance_signal(
            mix, params)[0]
        got = _proc(dictionary, StreamConfig(target_mode=TARGET_MODE_BOXCAR, num_h_updates=3)
                    ).enhance_signal(mix, params)[0]
        np.testing.assert_allclose(got, want, atol=1e-3 * max(float(np.abs(want).max()), 1e-9))


# ---- the port against the JAX engine ----------------------------------------

def _jax_params(**kw):
    return jrt.StreamParams.default(**kw)


def _both(w, cfg):
    return _proc(w, cfg), jrt.RTGCCNMFProcessor(w, cfg)


def _run_both(w, cfg, blocks, kw, state=None):
    """Step both engines over ``blocks`` (nb, B, C, block) with the same
    parameters; per block the outputs, coefficient masks and states."""
    port, jproc = _both(w, cfg)
    p_params, j_params = StreamParams.default(**kw, device=CPU), _jax_params(**kw)
    p_state = port.init_state(blocks.shape[1]) if state is None else state[0]
    j_state = jproc.init_state(blocks.shape[1]) if state is None else state[1]
    rows = []
    for blk in blocks:
        p_state, p_out, p_tel = port.step(p_state, torch.from_numpy(blk), p_params)
        j_state, j_out, j_tel = jproc.step(j_state, blk, j_params)
        rows.append(dict(out=(p_out.numpy(), np.asarray(j_out)),
                         mask=(p_tel["coefficient_mask"].numpy(),
                               np.asarray(j_tel["coefficient_mask"])),
                         state=(p_state, j_state)))
    return rows


def _blocks(mix, cfg, nb, batch=2):
    """(nb, batch, C, block): the mixture and its channel-swapped copy."""
    pair = np.stack([mix, mix[::-1]])[:batch, :, : nb * cfg.block_size]
    return np.ascontiguousarray(
        np.moveaxis(pair.reshape(batch, 2, nb, cfg.block_size), 2, 0)).astype(np.float32)


AGAINST_JAX = [
    pytest.param(dict(target_mode=mode, extra_delay_blocks=delay, num_h_updates=nh),
                 id=f"{name}-delay{delay}-h{nh}")
    for name, mode in (("window", 2), ("boxcar", 0)) for delay in (0, 1) for nh in (0, 2)
]


@pytest.mark.parametrize("fields", AGAINST_JAX)
def test_against_jax_block_by_block(stereo_signal, dictionary, fields):
    """The same seeded blocks through both engines, localization on: the
    coefficient masks agree on > 0.995 (an argmax may flip at a near-tie
    between two CPU GEMM libraries), the waveforms meet the oracle's bars,
    and after every block each state leaf agrees, ``target_idx`` exactly;
    the overlap-add ring within 1e-5 x max wherever the masks agreed so
    far."""
    mix, _ = stereo_signal
    cfg = StreamConfig(**fields)
    rows = _run_both(dictionary, cfg, _blocks(mix, cfg, 24),
                     dict(localization_enabled=True, target_epsilon=3.0, localization_window=4))
    masks = np.stack([r["mask"][0] for r in rows]), np.stack([r["mask"][1] for r in rows])
    agree = _mask_agreement(*masks)
    assert agree > 0.995, agree
    outs = [np.concatenate([r["out"][i] for r in rows], axis=-1) for i in (0, 1)]
    _oracle_bars(outs[0], outs[1])
    flipped = False
    for r in rows:
        p, j = r["state"]
        flipped |= _mask_agreement(*r["mask"]) < 1.0
        np.testing.assert_array_equal(p.carry_in.numpy(), np.asarray(j.carry_in))
        np.testing.assert_array_equal(p.hist_count.numpy(), np.asarray(j.hist_count))
        np.testing.assert_array_equal(p.target_idx.numpy(), np.asarray(j.target_idx))
        np.testing.assert_allclose(p.gcc_history.numpy(), np.asarray(j.gcc_history), atol=1e-6)
        assert p.delay_buf.shape == np.asarray(j.delay_buf).shape
        if not flipped:
            scale = max(float(np.abs(np.asarray(j.ola_acc)).max()), 1e-9)
            np.testing.assert_allclose(p.ola_acc.numpy(), np.asarray(j.ola_acc),
                                       atol=1e-5 * scale)
            np.testing.assert_allclose(p.delay_buf.numpy(), np.asarray(j.delay_buf),
                                       atol=1e-5 * scale)


@pytest.mark.parametrize("nh", [0, 2])
def test_passthrough_and_all_pass_match_jax(stereo_signal, dictionary, nh):
    """Masks that are 1 everywhere leave no argmax to flip: separation off,
    and a boxcar passing every TDOA (with H updates, the H-aware mask ≈ 1),
    agree with JAX at atol 1e-5."""
    mix, _ = stereo_signal
    for cfg, kw in (
        (StreamConfig(num_h_updates=nh), dict(separation_enabled=False)),
        (StreamConfig(target_mode=TARGET_MODE_BOXCAR, num_h_updates=nh),
         dict(target_epsilon=1e6, localization_enabled=False)),
    ):
        rows = _run_both(dictionary, cfg, _blocks(mix, cfg, 12), kw)
        for r in rows:
            np.testing.assert_allclose(*r["out"], atol=1e-5)


def test_low_latency_matches_jax(stereo_signal, dictionary):
    """The asymmetric windows at hop 128 (one frame a block) against JAX."""
    mix, _ = stereo_signal
    cfg = StreamConfig(hop_size=128, block_size=128, analysis_window="asymmetric",
                       synthesis_length=256)
    rows = _run_both(dictionary, cfg, _blocks(mix, cfg, 48, batch=1),
                     dict(target_tdoa_index=30.0, localization_enabled=False))
    assert _mask_agreement(np.stack([r["mask"][0] for r in rows]),
                           np.stack([r["mask"][1] for r in rows])) > 0.995
    _oracle_bars(*(np.concatenate([r["out"][i] for r in rows], axis=-1) for i in (0, 1)))


def test_resume_from_a_jax_state(stereo_signal, dictionary):
    """JAX runs k blocks; its state crosses with ``stream_state_from_numpy``
    and both engines run on from it, at the oracle's bars, with the same
    target after every block."""
    mix, _ = stereo_signal
    cfg = StreamConfig(extra_delay_blocks=1)
    blocks = _blocks(mix, cfg, 20)
    jproc = jrt.RTGCCNMFProcessor(dictionary, cfg)
    params = dict(localization_enabled=True)
    j_state = jproc.init_state(2)
    for blk in blocks[:8]:
        j_state, _, _ = jproc.step(j_state, blk, _jax_params(**params))
    leaves = {k: np.asarray(v) for k, v in j_state._asdict().items()}
    p_state = stream_state_from_numpy(leaves)
    assert isinstance(p_state, StreamState)
    for a, b in zip(p_state, j_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rows = _run_both(dictionary, cfg, blocks[8:], params, state=(p_state, j_state))
    for r in rows:
        np.testing.assert_array_equal(r["state"][0].target_idx.numpy(),
                                      np.asarray(r["state"][1].target_idx))
    _oracle_bars(*(np.concatenate([r["out"][i] for r in rows], axis=-1) for i in (0, 1)))


def test_stream_state_from_numpy_checks(dictionary):
    state = jrt.RTGCCNMFProcessor(dictionary, StreamConfig()).init_state(3)
    leaves = {k: np.asarray(v) for k, v in state._asdict().items()}
    assert leaves["delay_buf"].shape == (3, 2, 0, 512)  # a zero-length FIFO crosses
    got = stream_state_from_numpy(state)  # the NamedTuple itself works too
    assert got.delay_buf.shape == (3, 2, 0, 512) and got.hist_count.dtype == torch.int32
    bad = [
        (dict(leaves, hist_count=leaves["hist_count"].astype(np.int64)), TypeError, "int32"),
        (dict(leaves, target_idx=leaves["target_idx"].astype(np.float64)), TypeError,
         "float32"),
        (dict(leaves, carry_in=leaves["carry_in"][0]), ValueError, "rank"),
        (dict(leaves, gcc_history=leaves["gcc_history"][:2]), ValueError, "batch"),
        (dict(leaves, ola_acc=leaves["ola_acc"][:, :1]), ValueError, "channel"),
        ({k: v for k, v in leaves.items() if k != "delay_buf"}, KeyError, "delay_buf"),
    ]
    for arrays, err, match in bad:
        with pytest.raises(err, match=match):
            stream_state_from_numpy(arrays)


def test_config_and_params_mirror_jax():
    assert [f.name for f in dataclasses.fields(StreamConfig)] == \
        [f.name for f in dataclasses.fields(jrt.StreamConfig)]
    for cfg_kw in (dict(), dict(analysis_window="asymmetric", hop_size=64, block_size=128,
                                synthesis_length=128, extra_delay_blocks=2)):
        p, j = StreamConfig(**cfg_kw), jrt.StreamConfig(**cfg_kw)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        for prop in ("windows_per_block", "num_freq", "ola_length", "synthesis_support",
                     "emit_lag", "algorithmic_latency_s"):
            assert getattr(p, prop) == getattr(j, prop)
    assert StreamParams._fields == jrt.StreamParams._fields
    assert StreamState._fields == jrt.StreamState._fields
    for p, j in zip(StreamParams.default(device=CPU), jrt.StreamParams.default()):
        assert p.numpy().item() == np.asarray(j).item()
    for v in ("window", "boxcar", "0", "2", "window_function"):
        assert parse_target_mode(v) == jrt.parse_target_mode(v)
    for v in ("1", "multiple", "nope"):
        with pytest.raises(ValueError):
            parse_target_mode(v)


@pytest.mark.parametrize("length", [1, 2, 255, 1024])
def test_windows_bit_for_bit(length):
    for name in ("hann_symmetric", "hann_periodic", "hamming_symmetric", "sqrt_hamming"):
        got, want = getattr(windows, name)(length), getattr(jwin, name)(length)
        assert got.dtype == np.float32 and np.array_equal(got, want), name
    if length >= 255:
        for args in [a for a in ((length, 24, 12), (length, 128, 64), (length, 256, 128))
                     if a[1] <= length]:
            for got, want in zip(windows.asymmetric_analysis_synthesis_pair(*args),
                                 jwin.asymmetric_analysis_synthesis_pair(*args)):
                assert np.array_equal(got, want)
            wa, ws = windows.asymmetric_analysis_synthesis_pair(*args)
            assert windows.cola_check(wa * ws, args[2]) == jwin.cola_check(wa * ws, args[2])
    for args in ((1024, 255, 64), (1024, 64, 64), (1024, 192, 128), (128, 256, 64)):
        with pytest.raises(ValueError):
            windows.asymmetric_analysis_synthesis_pair(*args)


def test_processor_rejects_bad_configs(dictionary):
    with pytest.raises(ValueError, match="divide"):
        _proc(dictionary, StreamConfig(block_size=700))
    with pytest.raises(ValueError, match="rows"):
        _proc(dictionary[:100])
    with pytest.raises(ValueError, match="analysis_window"):
        _proc(dictionary, StreamConfig(analysis_window="hann"))
