"""``GCCNMFEnhancer.enhance_batches`` on the CPU and the benchmark's
enhancement cell at test size: the plain reference
(``portbench/reference/offline_enhance.py``) against the JAX package's
enhancer, the pipelined entry against the reference and against
``enhance`` chunk by chunk, faults planted under the cell's entry reading
``correct`` false, and the entry's metrics."""

import ast
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gccnmf_tpu.models import offline as joffline
from gccnmf_torch import profiling
from gccnmf_torch.models import offline
from gccnmf_torch.models.offline import GCCNMFEnhancer, OfflineConfig
from gccnmf_torch.ops import gcc, masks

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import manifest  # noqa: E402
from reference import offline_enhance as ref  # noqa: E402

CELL = "enh_k1024_b16_60s_i16"
SEED = 2**31 + 4321


def _cfg(**kw):
    """The reference's configuration keys at a CPU test's size: window 256,
    hop 32, 16 TDOAs over 10 cm, the published mask parameters."""
    return dict(dict(window_size=256, hop_size=32, num_tdoas=16, mic_separation_m=0.1,
                     sample_rate=16000, target_epsilon=5.0, target_beta=2.0, noise_floor=0.0),
                **kw)


def _enhancer(cfg, w, num_h_updates=0):
    keys = ("window_size", "hop_size", "num_tdoas", "mic_separation_m", "sample_rate")
    return GCCNMFEnhancer(w, OfflineConfig(**{k: cfg[k] for k in keys},
                                           dictionary_size=w.shape[1],
                                           nmf_matmul_dtype="float32"),
                          target_epsilon=cfg["target_epsilon"], target_beta=cfg["target_beta"],
                          noise_floor=cfg["noise_floor"], num_h_updates=num_h_updates,
                          device="cpu")


def _mixtures(seed, b=2, n=4000):
    """int16 stereo mixtures (b, 2, n): two noise talkers at delays of a few
    samples, at half of full scale."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        s = rng.standard_normal((2, n)) * 0.1
        d0, d1 = rng.integers(-4, 5, size=2)
        mix = np.stack([s.sum(0), np.roll(s[0], d0) + 0.5 * np.roll(s[1], d1)])
        out.append(np.round(0.5 * mix / np.abs(mix).max() * 32767))
    return np.stack(out).astype(np.int16)


def _dictionary(seed, f=129, k=8):
    return (np.random.default_rng(seed).random((f, k)) + 1e-3).astype(np.float32)


def _quantized(x):
    return (np.trunc(np.clip(x * 32768.0, -32768, 32767)) / 32768.0).astype(np.float32)


def test_reference_matches_the_jax_enhancer():
    """The plain reference against the JAX package's ``GCCNMFEnhancer`` in
    float32 with a seeded random W: the same targets, the outputs within
    the port's bar against JAX (2e-4) plus one step of the int16 output."""
    cfg, w = _cfg(), _dictionary(3)
    x = _mixtures(5)
    jcfg = joffline.OfflineConfig(**{k: cfg[k] for k in ("window_size", "hop_size", "num_tdoas",
                                                         "mic_separation_m", "sample_rate")},
                                  dictionary_size=w.shape[1], nmf_matmul_dtype="float32")
    want = joffline.GCCNMFEnhancer(w, jcfg).enhance(x.astype(np.float32) / 32768.0)
    targets, got, _ = ref.enhance(torch.as_tensor(x), cfg, torch.as_tensor(w))
    np.testing.assert_array_equal(targets.numpy(), want["target_tdoa_index"])
    assert got.shape == want["enhanced"].shape
    np.testing.assert_allclose(got.numpy(), _quantized(want["enhanced"]),
                               atol=2e-4 + 1 / 32768, rtol=0)


@pytest.mark.parametrize("io_dtype", ["float32", "int16"])
def test_enhance_batches_matches_the_reference(io_dtype):
    """The pipelined entry on the CPU (float32 numerics) against the
    reference on the same int16 input: the same targets and the outputs,
    quantized to 16 bits as the reference's are, within 1e-4 relative
    (argmax near-ties, summation order and a step of the quantization)."""
    cfg, w = _cfg(), _dictionary(7)
    chunks = [_mixtures(s) for s in (11, 12)]
    feed = chunks if io_dtype == "int16" else [c.astype(np.float32) / 32768.0 for c in chunks]
    got = list(_enhancer(cfg, w).enhance_batches(feed, io_dtype=io_dtype))
    assert len(got) == len(chunks)
    for x, (out, targets) in zip(chunks, got):
        want_t, want, _ = ref.enhance(torch.as_tensor(x), cfg, torch.as_tensor(w))
        np.testing.assert_array_equal(targets, want_t.numpy())
        err = ref.relative_errors(torch.as_tensor(_quantized(out)), want).numpy()
        assert (err < 1e-4).all(), err


@pytest.mark.parametrize("num_h_updates", [0, 2])
@pytest.mark.parametrize("io_dtype", ["float32", "int16"])
def test_each_chunk_equals_enhance(io_dtype, num_h_updates):
    """Each chunk ``enhance_batches`` yields is what ``enhance`` returns for
    it (through the int16 program: its output quantized to 16 bits), bit
    for bit, with the H-update path too; no yielded array changes while
    later chunks run."""
    cfg, w = _cfg(), _dictionary(9)
    enh = _enhancer(cfg, w, num_h_updates)
    chunks = [_mixtures(s, b=3) for s in (21, 22, 23)]
    feed = chunks if io_dtype == "int16" else [c.astype(np.float32) / 32768.0 for c in chunks]
    got = list(enh.enhance_batches(iter(feed), io_dtype=io_dtype))
    kept = [o.copy() for o, _ in got]
    for x, (out, targets), out_kept in zip(chunks, got, kept):
        want = enh.enhance(x.astype(np.float32) / 32768.0)
        assert out.dtype == np.float32 and targets.dtype == np.int32
        np.testing.assert_array_equal(targets, want["target_tdoa_index"])
        expect = _quantized(want["enhanced"]) if io_dtype == "int16" else want["enhanced"]
        np.testing.assert_array_equal(out, expect)
        np.testing.assert_array_equal(out, out_kept)


def test_enhance_batches_spans_and_validation(tmp_path):
    """The shared pipeline's stages under ``gccnmf.enhance.*``, in the
    separator's order; an unknown I/O type raises; no chunk, no output."""
    cfg, w = _cfg(), _dictionary(2)
    enh = _enhancer(cfg, w)
    with profiling.trace(str(tmp_path)):
        out = list(enh.enhance_batches([_mixtures(s) for s in (1, 2)], io_dtype="int16"))
    assert len(out) == 2
    with open(tmp_path / "trace.json") as fh:
        names = [e["name"].removeprefix("gccnmf.enhance.") for e in sorted(
            (e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith("gccnmf.enhance.")), key=lambda e: e["ts"])]
    assert names == ["upload", "compute", "upload", "download", "compute", "download",
                     "materialize", "materialize"]
    with pytest.raises(ValueError, match="io_dtype"):
        list(enh.enhance_batches([_mixtures(1)], io_dtype="int8"))
    assert list(enh.enhance_batches([])) == []


def test_reference_and_entry_import_no_jax_and_nothing_of_the_port():
    for path in (BENCH / "reference" / "offline_enhance.py",
                 BENCH / "harness" / "roofline_enhance.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "gccnmf_tpu",
                                                  "gccnmf_torch"), (path, name)


# the cell at a CPU test's size: two mixtures of 1 s, a pool of two, 32
# atoms; the window closes on a count of chunks (seconds 0: the pool's size)
SMALL = dict(batch=2, seconds_per_mixture=1.0, pool=2, check_pools=2, trace_chunks=1)


def _small_cell():
    cell = manifest.load_cell(CELL, manifest.find_manifest(ROOT))
    return dataclasses.replace(cell, config=dict(cell.config, dictionary_size=32),
                               traffic=dict(cell.traffic, **SMALL))


def _run(cell, tmp_path):
    """The cell's entry run once, as ``harness/runner.py`` runs it (whose
    module guard this process, which holds JAX, would trip)."""
    drv = manifest.entry(cell.config["entry"])
    return drv.run(cell, seed=SEED, seconds=0.0, trace=False, device="cpu",
                   t0=time.perf_counter(), out_dir=tmp_path)


def test_the_small_cell_is_correct_and_reports_its_end_to_end_metrics(tmp_path):
    cell = _small_cell()
    rec = _run(cell, tmp_path)
    assert rec["check"]["correct"], rec["check"]["numbers"]
    assert rec["attempted"] == SMALL["pool"] and rec["check"]["failed"] == 0
    e2e = [x.name for x in cell.metrics if x.kind == "end_to_end"]
    assert sorted(e2e) == ["audio_s_per_s.bf16", "setup_s"]
    for name in e2e:
        assert manifest.metric_reader(name).read(rec) > 0, name
    assert set(rec["check"]["numbers"]) == {"missing_chunks", "target_gap_max", "enh_err_max",
                                            "enh_err_median"}


def _wrong_target(monkeypatch):
    orig = gcc.mean_angular_spectrum
    monkeypatch.setattr(gcc, "mean_angular_spectrum", lambda a: orig(a).roll(6, dims=-1))


def _wiener_mask_dropped(monkeypatch):
    monkeypatch.setattr(masks, "wiener_tf_mask",
                        lambda w, h: torch.ones((*h.shape[:-1], w.shape[0])))


def _k_and_d_transposed(monkeypatch):
    def transposed(coh_re, coh_im, cos_w, sin_w, num_tdoas):
        flat = coh_re.float() @ cos_w + coh_im.float() @ sin_w
        scores = flat.reshape(*coh_re.shape[:-1], -1, num_tdoas)  # read as (K, D)
        return torch.argmax(scores, dim=-1).to(torch.int32)

    monkeypatch.setattr(masks, "argmax_tdoa", transposed)


@pytest.mark.parametrize("fault", [_wrong_target, _wiener_mask_dropped, _k_and_d_transposed])
def test_planted_faults_are_not_correct(monkeypatch, tmp_path, fault):
    cell = _small_cell()
    fault(monkeypatch)
    check = _run(cell, tmp_path)["check"]
    assert not check["correct"], check["numbers"]


def test_the_fp8_control_is_not_correct():
    cell = _small_cell()
    drv = manifest.entry(cell.config["entry"])
    assert not drv.control(cell, SEED, torch.device("cpu"))["correct"]


def _traced_record():
    """A record as a traced card run leaves it: the three kernels' calls
    and device time, the window, and the program's spans."""
    from harness import roofline, roofline_enhance

    b, t, f, d, k, win, hop = 16, 7493, 513, 64, 1024, 1024, 128
    calls = {
        "frontend": [(*roofline.frontend_work(b, 960000, t, f, d, win, "bfloat16", 2),
                      "bfloat16")],
        "soft_mask": [(*roofline_enhance.soft_mask_work(b, t, f, d, k, "bfloat16", 2),
                       "bfloat16")],
        "tf_synthesis": [(*roofline_enhance.tf_synthesis_work(b, 2, t, f, k, win, hop,
                                                              "bfloat16", 2), "bfloat16")],
    }
    spans = {"gccnmf.enhance.compute": dict(count=1, s=0.004, self_s=0.004)}
    return {"offline": dict(audio_s=960.0, window_s=0.1, chunks=1, chunk_gaps_s=[0.1]),
            "trace": dict(window_s=0.1, busy_s=0.098, steps=1, calls=calls, kernels=40,
                          device_s_by_span={"frontend": 0.003, "soft_mask": 0.08,
                                            "tf_synthesis": 0.008},
                          device_s_outside_spans=0.002,
                          program=dict(window_s=0.1, idle_s=0.002, idle_unattributed_s=0.0,
                                       idle_s_by_span={}, spans=spans))}


def test_every_per_layer_metric_of_the_cell_reads_a_traced_record():
    """Each per-layer metric the cell names reads a number from a traced
    record (each roofline share within (0, 100]), and nothing, without
    raising, from an untraced one or one with no program span (a parent
    program without ``gccnmf.enhance.*``)."""
    cell = manifest.load_cell(CELL, manifest.find_manifest(ROOT))
    names = [m.name for m in cell.metrics if m.kind == "per_layer"]
    assert set(names) == {"soft_mask_roofline.bf16", "tf_synthesis_roofline.bf16",
                          "enhance.step_mfu.bf16", "device.idle_pct.enhance.bf16",
                          "enhance.chunk_p95_ms.bf16", "enhance.enqueue_ms_per_chunk.bf16",
                          "frontend_roofline.bf16", "offline.other_device_ms_per_chunk.bf16",
                          "offline.launches_per_chunk.bf16"}
    rec = _traced_record()
    bare = {"offline": rec["offline"], "trace": dict(rec["trace"], program=None)}
    for name in names:
        reader = manifest.metric_reader(name)
        value = reader.read(rec)
        assert value is not None and value > 0, name
        if "roofline" in name or "mfu" in name:
            assert value <= 100, (name, value)
        assert reader.read({"setup_s": 1.0}) is None, name
        if name.startswith("enhance.enqueue"):
            assert reader.read(bare) is None
    got = {n: manifest.metric_reader(n).read(rec) for n in names}
    assert got["enhance.enqueue_ms_per_chunk.bf16"] == pytest.approx(4.0)
    assert got["device.idle_pct.enhance.bf16"] == pytest.approx(2.0)
    assert got["offline.other_device_ms_per_chunk.bf16"] == pytest.approx(2.0)
    assert got["offline.launches_per_chunk.bf16"] == pytest.approx(40.0)
