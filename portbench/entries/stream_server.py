"""Entry of live serving cells: ``StreamServer.process`` ticks paced in an
open loop, every ``block_size / sample_rate`` seconds.

Set-up: import the port, make the dictionary (F, K) and a pool of stereo
talker pairs from the seed on the device, build the server (its CUDA graph
is captured at ``max_streams``), open every stream, run ``warmup_ticks``
ticks of the streams' own audio, then ``gc.collect()`` and
``gc.freeze()``.

Window: ticks fall due on a fixed schedule that does not wait for a late
tick. Each is timed from its due time to the return of ``process()`` with
every stream's output on the host; a stall counts against the ticks
behind it. Stream ``s`` plays pool signal ``s mod pool`` from a seeded
block offset, looping.

Traced run: the untraced window, then ``trace_ticks`` more ticks, paced
alike, under the profiler.

Check: once the window has closed and the server is freed, the whole
output of ``check_streams`` streams (drawn from the seed), warm-up ticks
included, is compared block by block with the plain reference
(``reference/stream_gccnmf.py``) run over each stream's whole input.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from harness import common, signals, trace as tracing
from reference import stream_gccnmf as ref

# a block is off when its error passes this share of its stream's RMS: far
# above the int16 grid's noise (about 2e-5), below one flipped localization
OFF = 1e-3


def dictionary(g, f: int, k: int, device):
    """A seeded nonnegative (F, K) dictionary, unit-norm atoms: a stand-in
    for a pretrained one, sparse across frequency as trained atoms are."""
    import torch

    w = torch.rand((f, k), generator=g, device=device) ** 4 + 1e-3
    return w / w.norm(dim=0, keepdim=True)


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    """The dictionary (F, K) on the host, and the pool ``(P, 2, L·block)``
    int16 on the host."""
    import torch

    g = signals.generator(seed, device)
    f = cfg["window_size"] // 2 + 1
    w = dictionary(g, f, cfg["dictionary_size"], device)
    sr, blk = cfg["sample_rate"], cfg["block_size"]
    p, length = traffic["pool"], traffic["pool_blocks"] * blk
    max_delay = max(1, int(cfg["mic_separation_m"] / ref.SPEED_OF_SOUND_M_S * sr))
    delays = signals.spread_delays(g, p, 2, max_delay, device)
    lo, hi = traffic["interferer_gain"]
    gains = torch.stack([torch.ones(p, device=device),
                         lo + (hi - lo) * torch.rand(p, generator=g, device=device)], dim=1)
    pool = signals.stereo_mixtures(g, p, length, sr, delays, gains, device)
    return w.cpu().numpy(), pool.cpu().numpy()


def stream_config(cfg: dict):
    from gccnmf_torch.models.realtime import StreamConfig, parse_target_mode

    return StreamConfig(
        sample_rate=cfg["sample_rate"], window_size=cfg["window_size"],
        hop_size=cfg["hop_size"], block_size=cfg["block_size"], num_tdoas=cfg["num_tdoas"],
        mic_separation_m=cfg["mic_separation_m"], history_length=cfg["history_length"],
        target_mode=parse_target_mode(cfg["target_mode"]))


class Feed:
    """Every stream's block at tick ``j``: stream ``s`` plays pool signal
    ``s mod P`` from block ``offset[s]`` on, looping."""

    def __init__(self, pool_i16: np.ndarray, streams: int, block: int, rng):
        p, _, length = pool_i16.shape
        self.blocks = length // block
        self.pool_i16 = pool_i16
        # (P, L, 2, block) float32 on the int16 grid: lossless on the wire
        self.pool = np.ascontiguousarray(
            pool_i16.reshape(p, 2, self.blocks, block).transpose(0, 2, 1, 3)
        ).astype(np.float32) / 32768.0
        self.which = np.arange(streams) % p
        self.offset = rng.integers(0, self.blocks, streams)
        self.block = block

    def tick(self, j: int) -> np.ndarray:
        return self.pool[self.which, (self.offset + j) % self.blocks]  # (N, 2, block)

    def stream_input(self, s: int, ticks: int) -> np.ndarray:
        """Stream ``s``'s int16 input over its first ``ticks`` ticks, (2, n)."""
        idx = (self.offset[s] + np.arange(ticks)) % self.blocks
        sig = self.pool_i16[self.which[s]].reshape(2, self.blocks, self.block)
        return sig[:, idx].reshape(2, -1)


def settings(cfg: dict):
    from gccnmf_torch.serving import StreamSettings

    return StreamSettings(target_epsilon=cfg["target_epsilon"], target_beta=cfg["target_beta"],
                          noise_floor=cfg["noise_floor"],
                          localization_window=cfg["localization_window"])


def paced(server, ids, feed: Feed, j0: int, ticks: int, interval: float, keep):
    """``ticks`` ticks due every ``interval`` seconds from now; returns
    (latency from due time, time inside ``process()``) per tick, in
    seconds."""
    lat, dur = np.empty(ticks), np.empty(ticks)
    nxt = dict(zip(ids, feed.tick(j0)))
    start = time.perf_counter() + interval
    for i in range(ticks):
        due = start + i * interval
        common.pace_until(due)
        tc = time.perf_counter()
        res = server.process(nxt)
        tr = time.perf_counter()
        lat[i], dur[i] = tr - due, tr - tc
        keep(res)
        nxt = dict(zip(ids, feed.tick(j0 + i + 1)))
    return lat, dur


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float, out_dir):
    import torch

    from gccnmf_torch.serving import StreamServer

    cfg, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    dev = torch.device(device)
    w, pool = make_inputs(cfg, traffic, seed, dev)
    rng = np.random.default_rng(seed)
    n = traffic["streams"]
    feed = Feed(pool, n, cfg["block_size"], rng)
    sampled = sorted(int(s) for s in rng.choice(n, size=min(traffic["check_streams"], n),
                                                replace=False))
    server = StreamServer(w, stream_config(cfg), max_streams=n,
                          pipeline_depth=cfg["pipeline_depth"], wire_dtype=cfg["wire_dtype"],
                          device=dev)
    ids = [server.open_stream(settings(cfg)) for _ in range(n)]
    outs = {s: [] for s in sampled}

    def keep(res):
        for s in sampled:
            outs[s].append(res[ids[s]])

    interval = cfg["block_size"] / cfg["sample_rate"]
    j = 0
    for _ in range(traffic["warmup_ticks"]):
        keep(server.process(dict(zip(ids, feed.tick(j)))))
        j += 1
    if cuda:
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    window = contextlib.ExitStack()
    if trace and cuda:  # the card's clocks and power beside the traced run's windows
        window.enter_context(common.SmiSampler(out_dir / "smi.csv"))
    ticks = int(round(seconds / interval))
    lat, dur = paced(server, ids, feed, j, ticks, interval, keep)
    j += ticks
    record = dict(setup_s=setup_s,
                  serve=dict(latency_s=lat.tolist(), process_s=dur.tolist(),
                             deadline_s=interval, streams=n))
    if trace:
        path = out_dir / "trace.json"
        prof = tracing.profile(path)
        prof.start()
        with tracing.span("window"):
            paced(server, ids, feed, j, traffic["trace_ticks"], interval, keep)
            if cuda:
                torch.cuda.synchronize(dev)
        prof.stop()
        j += traffic["trace_ticks"]
        red = tracing.reduce(path) if cuda else None
        if red is not None:
            red.update(steps=traffic["trace_ticks"])
            path.unlink()
        record["trace"] = red
    window.close()
    if cuda:
        torch.cuda.synchronize(dev)
        record["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    common.write_json(out_dir / "timings.json", dict(latency_s=lat.tolist(),
                                                     process_s=dur.tolist()))
    server.close()
    del server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    record["check"] = check(cfg, cell.limits, w, feed, sampled, outs, j, dev)
    record["attempted"] = ticks
    return record


def compare(cfg: dict, w: np.ndarray, x_i16: np.ndarray, out: np.ndarray, device,
            precision: str = "float32"):
    """Served outputs ``out`` (S, 2, n) against the reference in
    ``precision`` over the inputs ``x_i16`` (S, 2, n): each block's error
    over its stream's RMS, ``(S, L)``; each stream's error over its RMS,
    ``(S,)``; the blocks left out as near-tie localizations, ``(S, L)``."""
    import torch

    r, amb = ref.enhance(torch.as_tensor(x_i16, device=device),
                         torch.as_tensor(w, device=device), cfg, precision)
    num, den = ref.block_errors(torch.as_tensor(out, device=device), r, cfg["block_size"])
    num = torch.where(amb, 0.0, num)
    stream = num.pow(2).mean(dim=1).sqrt() / den
    return (num / den[:, None]).cpu().numpy(), stream.cpu().numpy(), amb.cpu().numpy()


def check(cfg: dict, limits: dict, w, feed: Feed, sampled, outs: dict, ticks: int,
          device) -> dict:
    """``correct`` and the numbers compared, each beside its limit: the
    share of blocks off by more than ``OFF`` of their stream's level (the
    precision: a sound program flips a near-tie argmax now and then, the
    step below float32 ten times as often; and a stream served wrong) and
    the worst tick's median block error over the streams (a tick served
    wrong); near-tie localizations are left out of both."""

    got = [len(outs[s]) for s in sampled]
    missing = sum(ticks - g for g in got)
    x = np.stack([feed.stream_input(s, ticks) for s in sampled])
    out = np.stack([np.concatenate(outs[s], axis=-1) if len(outs[s]) == ticks
                    else np.zeros((2, ticks * cfg["block_size"]), np.float32)
                    for s in sampled])
    err, stream, amb = compare(cfg, w, x, out, device)
    kept = err[~amb]
    tick = np.median(err, axis=0)
    numbers = {
        "missing_blocks": (missing, 0),
        "blocks_off_pct": (100.0 * float((kept > OFF).mean()), limits["blocks_off_pct"]),
        "tick_err_max": (float(tick.max()), limits["tick_err_max"]),
    }
    ok = all(np.isfinite(v) and v <= lim for v, lim in numbers.values())
    failed = int((tick > limits["tick_err_max"]).sum()) + missing
    return dict(correct=bool(ok), numbers=numbers, failed=failed,
                errors=dict(block=kept.tolist(), stream=stream.tolist(), tick=tick.tolist(),
                            near_tie_blocks=[float(amb.sum())]))


def control(cell, seed: int, device, ticks: int) -> dict:
    """The check of the control, the reference one step below the
    configuration's precision (``control_precision``) put in the server's
    place, over the first ``ticks`` ticks of the streams that a run of
    ``seed`` checks."""
    import torch

    cfg, traffic = cell.config, cell.traffic
    w, pool = make_inputs(cfg, traffic, seed, torch.device(device))
    rng = np.random.default_rng(seed)
    n = traffic["streams"]
    feed = Feed(pool, n, cfg["block_size"], rng)
    sampled = sorted(int(s) for s in rng.choice(n, size=min(traffic["check_streams"], n),
                                                replace=False))
    x = np.stack([feed.stream_input(s, ticks) for s in sampled])
    r = ref.enhance(torch.as_tensor(x, device=device), torch.as_tensor(w, device=device), cfg,
                    cfg["control_precision"])[0].cpu().numpy()
    outs = {s: list(np.split(r[i], ticks, axis=-1)) for i, s in enumerate(sampled)}
    return check(cfg, cell.limits, w, feed, sampled, outs, ticks, device)
