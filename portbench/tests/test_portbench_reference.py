"""The plain references against the port's plain path on the CPU, and
their independence from the program."""

import json
import subprocess
import sys

import numpy as np
import torch

from conftest import BENCH
from harness import signals
from reference import offline_gccnmf, stream_gccnmf

OFFLINE = dict(window_size=1024, hop_size=128, num_tdoas=128, mic_separation_m=1.0,
               dictionary_size=32, num_iterations=20, num_sources=3, sample_rate=16000,
               epsilon=1e-16)
STREAM = dict(window_size=1024, hop_size=512, block_size=512, num_tdoas=64,
              mic_separation_m=0.1, sample_rate=16000, localization_window=6,
              target_epsilon=5.0, target_beta=2.0)


def _mixtures(seed, batch, n, talkers, max_delay):
    g = signals.generator(seed, "cpu")
    delays = signals.spread_delays(g, batch, talkers, max_delay, "cpu")
    gains = 0.7 + 0.3 * torch.rand((batch, talkers), generator=g)
    return signals.stereo_mixtures(g, batch, n, 16000, delays, gains, "cpu")


def test_offline_reference_matches_the_port_on_the_cpu():
    from gccnmf_torch.models.offline import GCCNMFSeparator, OfflineConfig

    x = _mixtures(2**31 + 7, 2, 24000, 3, 47)
    targets, est, _ = offline_gccnmf.separate(x, OFFLINE)
    cfg = OfflineConfig(**{k: v for k, v in OFFLINE.items()})
    (got, got_targets), = GCCNMFSeparator(cfg, device="cpu").separate_batches(
        [x.numpy()], io_dtype="int16")
    assert np.array_equal(got_targets, targets.numpy())
    err = offline_gccnmf.relative_errors(torch.from_numpy(got), est)
    assert float(err.max()) < 1e-4  # int16 rounding of fp32 sums in another order


def test_stream_reference_matches_the_server_on_the_cpu():
    from gccnmf_torch.models.realtime import StreamConfig
    from gccnmf_torch.serving import StreamServer

    streams, ticks = 3, 30
    x = _mixtures(11, streams, ticks * 512, 2, 4)
    g = signals.generator(12, "cpu")
    w = torch.rand((513, 64), generator=g) ** 4 + 1e-3
    w = w / w.norm(dim=0)
    srv = StreamServer(w.numpy(), StreamConfig(), max_streams=streams, wire_dtype="int16",
                       device="cpu")
    ids = [srv.open_stream() for _ in range(streams)]
    xf = x.numpy().astype(np.float32) / 32768.0
    blocks = [srv.process({sid: xf[s, :, i * 512:(i + 1) * 512] for s, sid in enumerate(ids)})
              for i in range(ticks)]
    got = np.stack([np.concatenate([b[sid] for b in blocks], axis=-1) for sid in ids])
    want, near_tie = stream_gccnmf.enhance(x, w, STREAM)
    assert want.shape == got.shape and near_tie.shape == (streams, ticks)
    num, _ = stream_gccnmf.block_errors(torch.from_numpy(got), want, 512)
    assert float(num[~near_tie].max()) < 4.0 / 32768  # a few steps of the int16 grid


def test_the_references_import_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r); import reference.offline_gccnmf, "
            "reference.stream_gccnmf, harness.roofline, harness.signals; import json; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=BENCH).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert not tops & {"gccnmf_torch", "gccnmf_tpu", "jax", "jaxlib", "flax"}
