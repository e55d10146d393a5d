"""The port's multi-stream server (``gccnmf_torch/serving.py``) on the CPU:
every case of tests/test_serving.py, the two mesh tests on a
``local_mesh(4, devices=["cpu"] * 4)``, then the port's server against the
JAX server over the same ticks and settings, unsharded and sharded, and the
sharded server's own cases (the pipelined, async and int16 modes, slot
operations across a shard boundary). The captured-graph tick, unsharded and
sharded, is held on the card in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from gccnmf_tpu import serving as jserving
from gccnmf_torch.models.realtime import RTGCCNMFProcessor, StreamConfig, StreamParams
from gccnmf_torch.parallel.mesh import LocalMesh, local_mesh
from gccnmf_torch.serving import StreamServer, StreamSettings, float_to_pcm

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

CPU = "cpu"


def _server(w, cfg, **kw):
    return StreamServer(w, cfg, device=CPU, **kw)


@pytest.fixture(scope="module")
def w():
    rng = np.random.default_rng(0)
    return rng.random((513, 16)).astype(np.float32) + 1e-3


@pytest.fixture(scope="module")
def cfg():
    return StreamConfig()


def _signal(seed, blocks, cfg):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((blocks, cfg.num_channels, cfg.block_size)).astype(
            np.float32
        )
        * 0.1
    )


def test_open_close_slots(w, cfg):
    srv = _server(w, cfg, max_streams=2)
    a = srv.open_stream()
    b = srv.open_stream()
    assert srv.active_streams == 2
    with pytest.raises(RuntimeError):
        srv.open_stream()
    srv.close_stream(a)
    c = srv.open_stream()
    assert c != a and srv.active_streams == 2
    srv.close_stream(b)
    srv.close_stream(c)
    assert srv.active_streams == 0


def test_matches_single_stream_processor(w, cfg):
    """A served stream must produce the same audio as a dedicated
    batch-1 processor fed the same blocks with the same settings."""
    srv = _server(w, cfg, max_streams=4)
    settings = StreamSettings(localization_enabled=True)
    sid = srv.open_stream(settings)
    blocks = _signal(1, 6, cfg)

    proc = RTGCCNMFProcessor(w, cfg, device=CPU)
    state = proc.init_state(1)
    params = StreamParams.default(device=CPU)

    for i in range(6):
        served = srv.process({sid: blocks[i]})[sid]
        state, solo, _ = proc.step(state, blocks[i][None], params)
        np.testing.assert_allclose(served, solo[0].numpy(), atol=1e-5)


def test_stream_isolation(w, cfg):
    """A stream's output is unchanged by other tenants coming and going."""
    blocks = _signal(2, 5, cfg)

    srv_solo = _server(w, cfg, max_streams=4)
    sid_solo = srv_solo.open_stream()
    solo_out = [srv_solo.process({sid_solo: blocks[i]})[sid_solo] for i in range(5)]

    srv_busy = _server(w, cfg, max_streams=4)
    sid = srv_busy.open_stream()
    noisy = srv_busy.open_stream(StreamSettings(target_tdoa_index=5.0))
    for i in range(5):
        subs = {sid: blocks[i]}
        if i < 3:
            subs[noisy] = _signal(99, 5, cfg)[i] * 3.0
        if i == 3:
            srv_busy.close_stream(noisy)
            srv_busy.open_stream(StreamSettings(separation_enabled=False))
        out = srv_busy.process(subs)
        np.testing.assert_allclose(out[sid], solo_out[i], atol=1e-5)


def test_slot_reset_on_reuse(w, cfg):
    """Reopened slots start from fresh state, not the previous tenant's."""
    srv = _server(w, cfg, max_streams=1)
    blocks = _signal(3, 4, cfg)
    a = srv.open_stream()
    for i in range(4):
        srv.process({a: blocks[i]})
    srv.close_stream(a)
    b = srv.open_stream()
    out_b = [srv.process({b: blocks[i]})[b] for i in range(4)]

    fresh = _server(w, cfg, max_streams=1)
    c = fresh.open_stream()
    out_c = [fresh.process({c: blocks[i]})[c] for i in range(4)]
    for x, y in zip(out_b, out_c):
        np.testing.assert_allclose(x, y, atol=1e-6)


def test_per_stream_settings_differ(w, cfg):
    """Streams with different mask settings produce different outputs for
    the same input; passthrough (separation off) reproduces more energy."""
    srv = _server(w, cfg, max_streams=3)
    sharp = srv.open_stream(
        StreamSettings(target_epsilon=1.0, localization_enabled=False)
    )
    off = srv.open_stream(StreamSettings(separation_enabled=False))
    blocks = _signal(4, 8, cfg)
    outs = {sharp: [], off: []}
    for i in range(8):
        out = srv.process({sharp: blocks[i], off: blocks[i]})
        outs[sharp].append(out[sharp])
        outs[off].append(out[off])
    e_sharp = float(np.sum(np.concatenate(outs[sharp], axis=-1) ** 2))
    e_off = float(np.sum(np.concatenate(outs[off], axis=-1) ** 2))
    assert e_off > e_sharp > 0


def test_update_stream_settings(w, cfg):
    srv = _server(w, cfg, max_streams=1)
    sid = srv.open_stream()
    srv.update_stream(sid, target_epsilon=2.5, separation_enabled=False)
    with pytest.raises(AttributeError):
        srv.update_stream(sid, bogus=1)
    blocks = _signal(5, 2, cfg)
    out = srv.process({sid: blocks[0]})
    assert out[sid].shape == (cfg.num_channels, cfg.block_size)
    assert sid in srv.telemetry


def test_missing_block_is_silence(w, cfg):
    """Streams that skip a tick still advance (output stays well-formed)."""
    srv = _server(w, cfg, max_streams=2)
    a = srv.open_stream()
    b = srv.open_stream()
    blocks = _signal(6, 3, cfg)
    out = srv.process({a: blocks[0], b: blocks[0]})
    assert set(out) == {a, b}
    out = srv.process({a: blocks[1]})  # b skips
    assert set(out) == {a}
    out = srv.process({a: blocks[2], b: blocks[2]})
    assert np.isfinite(out[b]).all()


def test_update_stream_all_or_nothing(w, cfg):
    """A typo'd key must not half-apply the earlier keys (that desyncs the
    recorded settings from the cached device params)."""
    srv = _server(w, cfg, max_streams=1)
    sid = srv.open_stream(StreamSettings(target_epsilon=5.0))
    with pytest.raises(AttributeError, match="bogus"):
        srv.update_stream(sid, target_epsilon=2.0, bogus=3.0)
    slot = srv._ids[sid]
    assert srv._settings[slot].target_epsilon == 5.0  # unchanged


def test_shared_settings_object_does_not_alias_tenants(w, cfg):
    """One StreamSettings object passed to several open_stream calls must
    not make update_stream on one tenant mutate the others (the server
    stores a private copy)."""
    shared = StreamSettings(noise_floor=0.0)
    srv = _server(w, cfg, max_streams=2)
    a = srv.open_stream(shared)
    b = srv.open_stream(shared)
    srv.update_stream(a, noise_floor=0.5)
    assert srv._settings[srv._ids[a]].noise_floor == 0.5
    assert srv._settings[srv._ids[b]].noise_floor == 0.0  # untouched
    assert shared.noise_floor == 0.0  # the caller's object too


def test_process_rejects_wrong_block_shape(w, cfg):
    """A mono or flat block would silently numpy-broadcast into both
    channels of the slot (degenerate GCC-PHAT, wrong output, no error) —
    it must be rejected with the expected shape in the message."""
    srv = _server(w, cfg, max_streams=1)
    sid = srv.open_stream()
    good = _signal(2, 1, cfg)[0]
    srv.process({sid: good})
    for bad in (
        np.zeros(cfg.block_size, np.float32),  # flat
        np.zeros((1, cfg.block_size), np.float32),  # mono
        np.zeros((cfg.num_channels, cfg.block_size - 1), np.float32),
    ):
        with pytest.raises(ValueError, match="block shape"):
            srv.process({sid: bad})


def test_silent_ticks_do_not_poison_localization(w, cfg):
    """All-zero blocks (idle slots, digital silence) must not write NaN
    GCC-PHAT into the localization history ring: one NaN row would make
    the windowed mean (NaN·0 = NaN) snap the localized target to index 0
    for the whole history length. The streaming step guards exact zeros
    (bit-identical coherence on nonzero bins)."""
    srv = _server(w, cfg, max_streams=2)
    a = srv.open_stream(StreamSettings(localization_enabled=True))
    rng = np.random.default_rng(9)
    sig = (
        rng.standard_normal((6, cfg.num_channels, cfg.block_size)) * 0.1
    ).astype(np.float32)
    srv.process({a: sig[0]})
    for _ in range(3):  # a skips ticks -> its slot gets exact-zero blocks
        srv.process({})
    srv.process({a: np.zeros_like(sig[0])})  # explicit digital silence
    for i in range(1, 6):
        out = srv.process({a: sig[i]})
    assert np.isfinite(out[a]).all()
    # the poisoning is invisible through argmax (argmax of NaN is a finite
    # 0) — assert the history state itself stayed NaN-free
    assert torch.isfinite(srv._shards[0].state.gcc_history).all()


def _cpu_mesh(n=4):
    return local_mesh(n, devices=[CPU] * n)


def test_mesh_sharded_server_matches_single_device(w, cfg):
    """A StreamServer with the slot batch sharded over a data mesh produces
    the same outputs and telemetry as the unsharded server (the step is
    slot-local: zero per-tick collectives)."""
    srv_a = _server(w, cfg, max_streams=8)
    srv_b = StreamServer(w, cfg, max_streams=8, mesh=_cpu_mesh())
    ids_a = [srv_a.open_stream(StreamSettings(target_tdoa_index=10.0 + i))
             for i in range(3)]
    ids_b = [srv_b.open_stream(StreamSettings(target_tdoa_index=10.0 + i))
             for i in range(3)]
    blocks = _signal(7, 4, cfg)
    for t in range(4):
        subs_a = {i: blocks[t] for i in ids_a}
        subs_b = {i: blocks[t] for i in ids_b}
        out_a = srv_a.process(subs_a)
        out_b = srv_b.process(subs_b)
        for ia, ib in zip(ids_a, ids_b):
            np.testing.assert_allclose(out_a[ia], out_b[ib], atol=2e-5)
    tel_a, tel_b = srv_a.telemetry, srv_b.telemetry
    for ia, ib in zip(ids_a, ids_b):
        assert tel_a[ia]["target_tdoa_index"] == pytest.approx(
            tel_b[ib]["target_tdoa_index"]
        )


def test_mesh_sharded_server_rejects_bad_tenancy(w, cfg):
    with pytest.raises(ValueError, match="multiple of the data-axis"):
        StreamServer(w, cfg, max_streams=6, mesh=_cpu_mesh())


def test_local_mesh_layout_and_errors():
    """``local_mesh``: JAX's data-axis shape, the first ``data`` devices,
    make_mesh's "exceeds" error, one device type, the card by default."""
    mesh = local_mesh(2, devices=[CPU, "cpu", "cpu"])
    assert mesh == LocalMesh((torch.device(CPU),) * 2) and mesh.shape == {"data": 2}
    with pytest.raises(ValueError, match="exceeds 1 devices"):
        local_mesh(2, devices=[CPU])
    with pytest.raises(ValueError, match="at least one shard"):
        local_mesh(0, devices=[CPU])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="exceeds 0 devices"):
            local_mesh(1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            local_mesh(2, devices=[CPU, "cuda:0"])


def test_mesh_server_rejects_a_disagreeing_device_or_mesh(w, cfg):
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        StreamServer(w, cfg, max_streams=4, mesh=_cpu_mesh(), device="cuda")
    with pytest.raises(TypeError, match="LocalMesh"):
        StreamServer(w, cfg, max_streams=4, mesh=object())
    srv = StreamServer(w, cfg, max_streams=4, mesh=_cpu_mesh(), device=CPU)
    assert [(s.start, s.stop) for s in srv._shards] == [(0, 1), (1, 2), (2, 3), (3, 4)]


MESH_MODES = [
    pytest.param(dict(pipeline_depth=2, async_fetch=True), id="depth2-async"),
    pytest.param(dict(pipeline_depth=1, wire_dtype="int16"), id="depth1-int16"),
    pytest.param(dict(pipeline_depth=2, async_fetch=True, wire_dtype="int16"),
                 id="depth2-async-int16"),
]


def _drain(srv, ticks):
    """Every stream's outputs over ``ticks`` (a list of submissions), in the
    order they arrive, the flushed tail included."""
    got = {}
    for subs in ticks:
        for sid, out in srv.process(subs).items():
            got.setdefault(sid, []).append(out)
    for tail in srv.flush():
        for sid, out in tail.items():
            got.setdefault(sid, []).append(out)
    srv.close()
    return {sid: np.concatenate(blocks, axis=-1) for sid, blocks in got.items()}


@pytest.mark.parametrize("mode", MESH_MODES)
def test_mesh_modes_match_unsharded(w, cfg, mode):
    """Pipelined, async-fetch and int16-wire sharded servers deliver what
    the unsharded server in the same mode delivers, with the same
    telemetry after every tick."""
    blocks = _signal(12, 6, cfg)
    plain, sharded = _server(w, cfg, max_streams=8, **mode), StreamServer(
        w, cfg, max_streams=8, mesh=_cpu_mesh(), **mode)
    settings = [StreamSettings(target_tdoa_index=5.0 + 3 * i, localization_enabled=i % 2 == 0)
                for i in range(6)]
    ids = [(plain.open_stream(s), sharded.open_stream(s)) for s in settings]
    outs = {}
    for srv, side in ((plain, 0), (sharded, 1)):
        ticks = [{pair[side]: blocks[t] * (1 + i) for i, pair in enumerate(ids)}
                 for t in range(6)]
        outs[side] = _drain(srv, ticks)
    for a, b in ids:
        np.testing.assert_allclose(outs[1][b], outs[0][a], atol=2e-5)
    tp, ts = plain.telemetry, sharded.telemetry
    assert [tp[a]["target_tdoa_index"] for a, _ in ids] == \
        [ts[b]["target_tdoa_index"] for _, b in ids]


def test_mesh_slot_operations_touch_only_their_shard(w, cfg):
    """Opening, closing and resetting slots at a shard boundary, and
    ``update_stream`` on a slot of the last shard: every other stream gives
    what it gives on an untouched sharded server, and the changed streams
    what they give on the unsharded server under the same operations."""
    blocks = _signal(13, 6, cfg)
    mesh = _cpu_mesh()

    def run(srv, churn):
        sids = [srv.open_stream(StreamSettings(target_tdoa_index=8.0 + i)) for i in range(8)]
        got = {sid: [] for sid in sids}
        for t in range(6):
            if churn and t == 2:
                # slots 3 and 4 straddle the boundary of shards 1 and 2
                srv.close_stream(sids[3])
                srv.close_stream(sids[4])
                sids[3] = srv.open_stream(StreamSettings(separation_enabled=False))
                sids[4] = srv.open_stream()
                got[sids[3]], got[sids[4]] = [], []
                srv.update_stream(sids[7], target_epsilon=1.0, noise_floor=0.3)
            for sid, out in srv.process({sid: blocks[t] for sid in sids}).items():
                got[sid].append(out)
        return [np.concatenate(got[sid], axis=-1) for sid in sids]

    quiet = run(StreamServer(w, cfg, max_streams=8, mesh=mesh), churn=False)
    churned = run(StreamServer(w, cfg, max_streams=8, mesh=mesh), churn=True)
    unsharded = run(_server(w, cfg, max_streams=8), churn=True)
    for i in (0, 1, 2, 5, 6):
        np.testing.assert_array_equal(churned[i], quiet[i])
    for i in (3, 4, 7):
        assert not np.allclose(churned[i], quiet[i][..., -churned[i].shape[-1]:], atol=1e-6)
        np.testing.assert_allclose(churned[i], unsharded[i], atol=2e-5)


def test_pipelined_matches_unpipelined(w, cfg):
    """pipeline_depth=2 must return exactly the same per-stream audio, two
    ticks late, with flush() draining the tail."""
    srv0 = _server(w, cfg, max_streams=4)
    srv2 = _server(w, cfg, max_streams=4, pipeline_depth=2)
    sid0 = srv0.open_stream()
    sid2 = srv2.open_stream()
    blocks = _signal(3, 8, cfg)

    expected = [srv0.process({sid0: b})[sid0] for b in blocks]
    got = []
    for b in blocks:
        out = srv2.process({sid2: b})
        if out:
            got.append(out[sid2])
    assert len(got) == 6  # 8 submitted, 2 still in flight
    for tail in srv2.flush():
        got.append(tail[sid2])
    assert len(got) == 8
    for e, g in zip(expected, got):
        np.testing.assert_allclose(g, e, atol=1e-6)


def test_async_fetch_matches_sync_pipeline(w, cfg):
    """async_fetch (the fetch thread that takes the blocking device→host
    wait off the tick path) must deliver exactly the same
    per-stream audio in the same order as the sync pipelined server —
    only arrival timing may differ — and report delivery latency."""
    srv0 = _server(w, cfg, max_streams=4)
    srva = _server(
        w, cfg, max_streams=4, pipeline_depth=2, async_fetch=True
    )
    sid0 = srv0.open_stream()
    sida = srva.open_stream()
    blocks = _signal(3, 10, cfg)

    expected = [srv0.process({sid0: b})[sid0] for b in blocks]
    got = []
    for b in blocks:
        out = srva.process({sida: b})
        if out:
            got.append(out[sida])
    for tail in srva.flush():
        got.append(tail[sida])
    assert len(got) == 10
    for e, g in zip(expected, got):
        np.testing.assert_allclose(g, e, atol=1e-6)
    st = srva.tick_stats()
    assert st["delivery_ms"] is not None
    assert st["delivery_ms"]["window"] >= 8
    assert st["delivery_ms"]["p99"] >= st["delivery_ms"]["p50"] > 0
    srva.close()
    srva.close()  # idempotent


def test_async_fetch_backpressure_bounds_outstanding(w, cfg):
    """Outstanding ticks must never exceed pipeline_depth + 1 (the take
    blocks on the oldest) — the latency bound of the async path."""
    srv = _server(
        w, cfg, max_streams=1, pipeline_depth=2, async_fetch=True
    )
    sid = srv.open_stream()
    blocks = _signal(5, 12, cfg)
    for b in blocks:
        srv.process({sid: b})
        assert srv._fetcher.outstanding <= 3
    srv.close()
    assert srv._fetcher is None


def test_int16_wire_matches_float_within_quantization(w, cfg):
    """wire_dtype='int16' (half the per-tick link bytes) must equal the
    float32 server up to output PCM quantization when fed int16-born
    audio (the deployment case): same f32 blocks enter the step either
    way, so only the writer-exact output quantization differs."""
    srv_f = _server(w, cfg, max_streams=2)
    srv_i = _server(w, cfg, max_streams=2, wire_dtype="int16")
    sf, si = srv_f.open_stream(), srv_i.open_stream()
    blocks = _signal(7, 6, cfg)
    # int16-born input: exactly representable in both paths
    blocks = np.round(np.clip(blocks, -1, 0.999) * 32768.0) / 32768.0
    blocks = blocks.astype(np.float32)
    for b in blocks:
        out_f = srv_f.process({sf: b})[sf]
        out_i = srv_i.process({si: b})[si]
        assert out_i.dtype == np.float32
        np.testing.assert_allclose(out_i, out_f, atol=2.0**-15 + 1e-7)
    # quantization grid: every int16-wire sample is a multiple of 2^-15
    assert np.allclose(out_i * 32768.0, np.round(out_i * 32768.0), atol=1e-4)


def test_int16_wire_with_async_pipeline(w, cfg):
    """int16 wire composes with the production async pipeline shape."""
    srv = _server(
        w, cfg, max_streams=1, pipeline_depth=2, async_fetch=True,
        wire_dtype="int16",
    )
    sid = srv.open_stream()
    blocks = _signal(9, 5, cfg)
    got = [out[sid] for b in blocks if (out := srv.process({sid: b}))]
    got += [t[sid] for t in srv.flush()]
    assert len(got) == 5 and all(g.dtype == np.float32 for g in got)
    srv.close()
    with pytest.raises(ValueError, match="wire_dtype"):
        _server(w, cfg, max_streams=1, wire_dtype="int8")


def test_fetch_worker_surfaces_fetch_failure(w, cfg):
    """A device error inside the worker's fetch must re-raise on the tick
    thread, not kill the worker silently and strand take(block=True)."""
    from gccnmf_torch.serving import _FetchWorker

    def poisoned():
        raise RuntimeError("device fell over")

    worker = _FetchWorker()
    try:
        worker.submit(poisoned, {0: 0}, 0.0)
        with pytest.raises(RuntimeError, match="device fell over"):
            worker.take(block=True)
        # the worker thread survived the failure: a good item still flows
        worker.submit(lambda: np.zeros((1, 2, 4), np.float32), {0: 0}, 0.0)
        out_np, submitted, _, _ = worker.take(block=True)
        assert submitted == {0: 0} and out_np.shape == (1, 2, 4)
        assert worker.outstanding == 0
    finally:
        worker.stop()


def test_pipelined_close_still_returns_inflight_output(w, cfg):
    """A stream closed (and its slot re-tenanted) while its tick is still
    in the pipeline must get its own audio back, not the new tenant's."""
    srv = _server(w, cfg, max_streams=1, pipeline_depth=1)
    sid_a = srv.open_stream()
    block = _signal(4, 1, cfg)[0]
    assert srv.process({sid_a: block}) == {}
    srv.close_stream(sid_a)
    sid_b = srv.open_stream()
    out = srv.process({sid_b: np.zeros_like(block)})
    assert set(out) == {sid_a}  # tick 0's output, attributed to A
    tail = srv.flush()
    assert len(tail) == 1 and set(tail[0]) == {sid_b}


def test_nan_tenant_is_isolated_and_recoverable(w, cfg):
    """A tenant submitting NaN/Inf blocks must not poison co-tenants (the
    step has no cross-batch reduction: every op is slot-local), and the
    slot must come back clean after close/reopen (state reset)."""
    blocks = _signal(4, 6, cfg)

    srv_solo = _server(w, cfg, max_streams=2)
    sid_solo = srv_solo.open_stream()
    solo_out = [
        srv_solo.process({sid_solo: blocks[i]})[sid_solo] for i in range(6)
    ]

    srv = _server(w, cfg, max_streams=2)
    good = srv.open_stream()
    bad = srv.open_stream()
    poison = np.full((cfg.num_channels, cfg.block_size), np.nan, np.float32)
    poison[0, 0] = np.inf
    for i in range(4):
        out = srv.process({good: blocks[i], bad: poison})
        # the co-tenant's waveform is bit-for-bit the solo run's
        np.testing.assert_allclose(out[good], solo_out[i], atol=1e-5)
    out = srv.process({good: blocks[4], bad: poison})
    assert not np.isfinite(out[bad]).all()
    np.testing.assert_allclose(out[good], solo_out[4], atol=1e-5)
    # recovery: retire the poisoned stream; the reused slot starts fresh
    srv.close_stream(bad)
    clean = srv.open_stream()
    out = srv.process({good: blocks[5], clean: blocks[5]})
    np.testing.assert_allclose(out[good], solo_out[5], atol=1e-5)
    assert np.isfinite(out[clean]).all()


def test_tick_stats_and_deadline_accounting(w, cfg):
    """Per-tick deadline accounting on the serving clock: cumulative
    tick/miss counters plus bounded-window wall times, surfaced by the
    serve command's JSON output via tick_stats()."""
    srv = _server(w, cfg, max_streams=2)
    sid = srv.open_stream()
    blocks = _signal(3, 4, cfg)
    for i in range(4):
        srv.process({sid: blocks[i]})
    st = srv.tick_stats()
    assert st["ticks"] == 4
    assert st["deadline_ms"] == pytest.approx(
        cfg.block_size / cfg.sample_rate * 1e3
    )
    assert 0 <= st["deadline_misses"] <= 4
    assert st["tick_ms"]["window"] == 4
    assert st["tick_ms"]["max"] >= st["tick_ms"]["min"] > 0
    # p50/p99 over the same window: the capacity metric, surfaced live
    assert (
        st["tick_ms"]["min"]
        <= st["tick_ms"]["p50"]
        <= st["tick_ms"]["p99"]
        <= st["tick_ms"]["max"]
    )
    # an impossible deadline must register as a miss (counter wiring)
    srv.deadline_s = 0.0
    srv.process({sid: blocks[0]})
    assert srv.deadline_misses >= 1 and srv.ticks == 5
    # host-memory watchdog: days-long serving surfaces anon-vs-budget in
    # its telemetry
    hm = st["host_mem"]
    assert set(hm) == {"anon_mib", "budget_mib", "exceeded"}
    assert hm["anon_mib"] > 0 and hm["exceeded"] is False
    assert st["host_heap_trims"] >= 0


def test_soak_open_close_churn_under_pipelining(w, cfg):
    """Sustained serving soak: open/close tenant churn under pipelined
    dispatch, finite outputs throughout, bounded in-flight queue, and host
    memory stability (ru_maxrss must not keep growing after warmup —
    the telemetry/params caches and tick counters are all bounded).

    Default length is ~1200 ticks (≈38 s of served audio per tenant);
    set GCCNMF_TPU_SOAK_SECONDS=180 for a true multi-minute soak run.
    """
    import os
    import resource
    import time

    srv = _server(w, cfg, max_streams=4, pipeline_depth=2)
    rng = np.random.default_rng(42)
    sids = [srv.open_stream() for _ in range(3)]
    target_s = float(os.environ.get("GCCNMF_TPU_SOAK_SECONDS", "0"))
    min_ticks = 1200
    warmup = 200
    rss_after_warmup = None
    t_start = time.perf_counter()
    tick = 0
    outputs_seen = 0
    while tick < min_ticks or time.perf_counter() - t_start < target_s:
        if tick % 97 == 96:  # churn: retire the oldest tenant, admit a new one
            srv.close_stream(sids.pop(0))
            sids.append(
                srv.open_stream(
                    StreamSettings(
                        target_tdoa_index=float(rng.uniform(8.0, 56.0))
                    )
                )
            )
        blocks = {
            sid: rng.standard_normal(
                (cfg.num_channels, cfg.block_size)
            ).astype(np.float32)
            * 0.05
            for sid in sids
        }
        out = srv.process(blocks)
        for b in out.values():
            outputs_seen += 1
            assert np.isfinite(b).all()
        assert len(srv._inflight) <= srv.pipeline_depth
        if tick == warmup:
            rss_after_warmup = resource.getrusage(
                resource.RUSAGE_SELF
            ).ru_maxrss
        tick += 1
    for tick_out in srv.flush():
        for b in tick_out.values():
            assert np.isfinite(np.asarray(b)).all()
    rss_end = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # ru_maxrss is KiB on Linux; steady-state serving must not keep
    # allocating (64 MiB of slack covers allocator noise)
    assert rss_end - rss_after_warmup < 64 * 1024
    st = srv.tick_stats()
    assert st["ticks"] >= min_ticks
    assert outputs_seen >= (min_ticks - srv.pipeline_depth) * 3 - 40
    assert srv.active_streams == 3
    assert srv.deadline_misses <= st["ticks"]


# ---- the port's server against the JAX server --------------------------------

SERVER_MODES = [
    pytest.param(dict(), id="sync"),
    pytest.param(dict(pipeline_depth=2, async_fetch=True), id="depth2-async"),
    pytest.param(dict(pipeline_depth=1, wire_dtype="int16"), id="depth1-int16"),
]


def _jax_mesh():
    import jax
    from gccnmf_tpu.parallel import mesh as jmesh

    return jmesh.make_mesh(data=4, model=1, devices=jax.devices()[:4])


@pytest.mark.parametrize("mode", SERVER_MODES)
def test_server_matches_jax(w, cfg, mode):
    """The same ticks through both servers: three tenants with their own
    settings, a settings change, a skipped tick, a close and a reopen. Each
    stream's audio meets the streaming oracle's bars against JAX's (SNR >
    25 dB, > 0.93 of samples within 3e-4 x max) and the localized targets
    are equal after every tick."""
    _check_against_jax(_server(w, cfg, max_streams=4, **mode),
                       jserving.StreamServer(w, cfg, max_streams=4, **mode), cfg, mode)


@pytest.mark.parametrize("mode", SERVER_MODES)
def test_mesh_server_matches_jax(w, cfg, mode):
    """:func:`test_server_matches_jax` with the four slots sharded over
    four devices on both sides: the port's ``local_mesh(4)`` of the CPU and
    JAX's ``make_mesh(data=4, model=1)`` of its CPU devices."""
    _check_against_jax(StreamServer(w, cfg, max_streams=4, mesh=_cpu_mesh(), **mode),
                       jserving.StreamServer(w, cfg, max_streams=4, mesh=_jax_mesh(), **mode),
                       cfg, mode)


def _check_against_jax(port, jax_, cfg, mode):
    settings = [jserving.StreamSettings(target_tdoa_index=20.0, localization_enabled=False),
                jserving.StreamSettings(target_epsilon=2.0, localization_window=3),
                jserving.StreamSettings(separation_enabled=False)]
    ids = [(port.open_stream(StreamSettings(**vars(s))), jax_.open_stream(s))
           for s in settings]
    blocks = _signal(11, 12, cfg)
    # each server's outputs per stream in the order they arrive. The sync
    # and pipelined servers deliver the same streams on the same tick; with
    # the async fetch a tick's output surfaces when its copy is done, which
    # may be a tick earlier on one server than on the other
    paired = not mode.get("async_fetch", False)
    pair_of_jax = {j: p for p, j in ids}
    got = {side: {} for side in ("port", "jax")}

    def collect(port_out, jax_out):
        if paired:
            assert set(port_out) == {pair_of_jax[j] for j in jax_out}
        for p, block in port_out.items():
            got["port"].setdefault(p, []).append(block)
        for j, block in jax_out.items():
            got["jax"].setdefault(pair_of_jax[j], []).append(block)

    for t in range(12):
        if t == 4:
            port.update_stream(ids[0][0], target_epsilon=1.5, noise_floor=0.2)
            jax_.update_stream(ids[0][1], target_epsilon=1.5, noise_floor=0.2)
        if t == 7:
            port.close_stream(ids[2][0])
            jax_.close_stream(ids[2][1])
            ids[2] = (port.open_stream(), jax_.open_stream())
            pair_of_jax[ids[2][1]] = ids[2][0]
        live = [pair for i, pair in enumerate(ids) if not (t == 5 and i == 1)]
        collect(port.process({p: blocks[t] * (1 + i) for i, (p, _) in enumerate(live)}),
                jax_.process({j: blocks[t] * (1 + i) for i, (_, j) in enumerate(live)}))
        tp, tj = port.telemetry, jax_.telemetry
        assert [tp[p]["target_tdoa_index"] for p, _ in ids] == \
            [tj[j]["target_tdoa_index"] for _, j in ids]
    if paired:
        tails = list(zip(port.flush(), jax_.flush(), strict=True))
    else:
        tails = [(tail, {}) for tail in port.flush()] + [({}, tail) for tail in jax_.flush()]
    for port_out, jax_out in tails:
        collect(port_out, jax_out)
    port.close()
    jax_.close()
    assert set(got["port"]) == set(got["jax"])
    for p, port_blocks in got["port"].items():
        a = np.concatenate(port_blocks, axis=-1)
        b = np.concatenate(got["jax"][p], axis=-1)
        assert a.shape == b.shape
        err = a - b
        assert 10 * np.log10((b ** 2).sum() / max((err ** 2).sum(), 1e-30)) > 25.0
        assert (np.abs(err) < 3e-4 * np.abs(b).max()).mean() > 0.93


def test_int16_nan_tenant_matches_jax(w, cfg):
    """On the int16 wire a NaN tenant's output is JAX's, and its co-tenant
    is bit-for-bit its solo run."""
    blocks = _signal(4, 4, cfg)
    poison = np.full((cfg.num_channels, cfg.block_size), np.nan, np.float32)
    solo = _server(w, cfg, max_streams=2, wire_dtype="int16")
    s = solo.open_stream()
    want = [solo.process({s: b})[s] for b in blocks]
    port = _server(w, cfg, max_streams=2, wire_dtype="int16")
    jax_ = jserving.StreamServer(w, cfg, max_streams=2, wire_dtype="int16")
    pg, pb, jg, jb = port.open_stream(), port.open_stream(), jax_.open_stream(), \
        jax_.open_stream()
    with np.errstate(invalid="ignore"):  # both hosts cast NaN to int16 alike
        for b, solo_out in zip(blocks, want):
            p, j = port.process({pg: b, pb: poison}), jax_.process({jg: b, jb: poison})
            assert np.array_equal(p[pg], solo_out)
            assert np.array_equal(p[pb], j[jb])


def test_pcm_cast_matches_jax():
    """The device-side PCM cast: clip, scale, truncate, NaN → 0 (JAX's
    conversion on the CPU)."""
    import jax.numpy as jnp

    x = np.array([np.nan, np.inf, -np.inf, 0.7, -0.99999, 1.0, 0.5 / 32768, -1e-9],
                 np.float32)
    want = (jnp.clip(jnp.asarray(x), -1.0, 1.0 - 2.0 ** -15) * 32768.0).astype(jnp.int16)
    assert float_to_pcm(torch.from_numpy(x)).numpy().tolist() == np.asarray(want).tolist()


def test_server_rejects_bad_options(w, cfg):
    with pytest.raises(ValueError, match="pipeline_depth"):
        _server(w, cfg, pipeline_depth=-1)
    with pytest.raises(ValueError, match="wire_dtype"):
        _server(w, cfg, wire_dtype="float16")
