"""Entry of offline separation cells: ``GCCNMFSeparator.separate_batches``
over an endless stream of equal chunks.

Set-up: import the port, build the separator, make a pool of distinct
int16 chunks from the seed (on the device), push one chunk through the
pipelined entry (which loads the kernels' library, building it in a fresh
checkout), then ``gc.collect()`` and ``gc.freeze()``.

Window: the entry runs over the pool, cycled. It opens at the first chunk
yielded and closes at the first chunk yielded ``seconds`` later; the audio
of the chunks after the first, over that time, is the rate.

Traced run (``trace``): the untraced window, then ``trace_chunks`` more
chunks of the same generator under the profiler, the three kernel
wrappers that ``models/offline.py`` binds wrapped in harness spans, each
call's work counted from its arguments (``harness/roofline.py``).

Check: once the window has closed and the program is freed, the last
output of each of ``check_pools`` pool chunks (drawn from the seed) is
compared with the plain reference (``reference/offline_gccnmf.py``) on the
same int16 input, by the numbers of :func:`check`, each against the cell's
limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from harness import common, roofline, signals, trace as tracing
from reference import offline_gccnmf as ref

SPANS = ("nmf", "frontend", "synthesis")
WRAPPED = {"nmf": "kl_nmf_cuda", "frontend": "stft_gcc_frontend_cuda",
           "synthesis": "masked_synthesis_cuda"}


def make_pool(cfg: dict, traffic: dict, seed: int, device):
    """``pool`` int16 chunks (B, 2, n) on the host, made on ``device``."""
    import torch

    g = signals.generator(seed, device)
    sr = cfg["sample_rate"]
    n = int(round(traffic["seconds_per_mixture"] * sr))
    b, s = traffic["batch"], cfg["num_sources"]
    max_delay = int(cfg["mic_separation_m"] / ref.SPEED_OF_SOUND_M_S * sr)
    lo, hi = traffic["talker_gain"]
    pool = []
    for _ in range(traffic["pool"]):
        delays = signals.spread_delays(g, b, s, max_delay, device)
        gains = lo + (hi - lo) * torch.rand((b, s), generator=g, device=device)
        pool.append(signals.stereo_mixtures(g, b, n, sr, delays, gains, device).cpu().numpy())
    return pool, n


def offline_config(cfg: dict):
    from gccnmf_torch.models.offline import OfflineConfig

    keys = ("window_size", "hop_size", "num_tdoas", "mic_separation_m", "dictionary_size",
            "num_iterations", "num_sources", "sample_rate", "nmf_matmul_dtype", "epsilon")
    return OfflineConfig(**{k: cfg[k] for k in keys})


def _work(name: str, cfg: dict, args, kwargs, out):
    """(flops, bytes, mode) of one wrapper call, from its arguments."""
    win = cfg["window_size"]
    mode = kwargs["matmul_dtype"]
    if name == "nmf":
        v, w0, h0, iters = args[:4]
        b = v.shape[0] if v.dim() == 3 else 1
        flops, nbytes = roofline.nmf_work(b, h0.shape[-2], w0.shape[-2], w0.shape[-1], iters,
                                          mode, v.element_size())
    elif name == "frontend":
        x, ang = args[0], out[5]
        plane = 2 if kwargs.get("plane_dtype") == "bfloat16" else 4
        flops, nbytes = roofline.frontend_work(x.shape[0], x.shape[-1], ang.shape[-2],
                                               win // 2 + 1, ang.shape[-1], win, mode, plane)
    else:
        sre, winner, w = args[0], args[2], args[3]
        flops, nbytes = roofline.synthesis_work(
            sre.shape[0], kwargs["num_targets"], winner.shape[-2], w.shape[-2], w.shape[-1],
            win, kwargs["hop_size"], mode, sre.element_size())
    return flops, nbytes, mode


class _Wrapped:
    """The three kernel wrappers of ``models/offline.py`` in harness spans,
    their work recorded per call, while the context is open."""

    def __init__(self, module, cfg):
        self.module, self.cfg = module, cfg
        self.calls = {k: [] for k in SPANS}
        self._saved = {}

    def __enter__(self):
        for name, attr in WRAPPED.items():
            fn = getattr(self.module, attr)
            self._saved[attr] = fn

            def inner(*a, _fn=fn, _name=name, **k):
                with tracing.span(_name):
                    out = _fn(*a, **k)
                self.calls[_name].append(_work(_name, self.cfg, a, k, out))
                return out

            setattr(self.module, attr, inner)
        return self

    def __exit__(self, *exc):
        for attr, fn in self._saved.items():
            setattr(self.module, attr, fn)
        return False


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float, out_dir):
    import torch

    from gccnmf_torch.models import offline
    from gccnmf_torch.models.offline import GCCNMFSeparator

    cfg, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    sep = GCCNMFSeparator(offline_config(cfg), device=device)
    dev = sep.device
    pool, n = make_pool(cfg, traffic, seed, dev)
    io = cfg["io_dtype"]
    for _ in sep.separate_batches([pool[0]], io_dtype=io):  # warm this cell's shapes
        pass
    if cuda:
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    rng = np.random.default_rng(seed)
    pools = len(pool)
    checked = sorted(int(p) for p in rng.choice(pools, size=min(traffic["check_pools"], pools),
                                                replace=False))

    def endless():
        i = 0
        while True:
            yield pool[i % pools]
            i += 1

    window = contextlib.ExitStack()
    if trace and cuda:  # the card's clocks and power beside the traced run's windows
        window.enter_context(common.SmiSampler(out_dir / "smi.csv"))
    kept = {}
    gen = sep.separate_batches(endless(), io_dtype=io)
    next(gen)
    t_first = time.perf_counter()
    times, idx = [t_first], 0
    while True:
        est, targets = next(gen)
        idx += 1
        times.append(time.perf_counter())
        if idx % pools in checked:
            kept[idx % pools] = (est, targets)
        if times[-1] - t_first >= seconds:
            break
    window_s = times[-1] - t_first
    record = dict(
        setup_s=setup_s,
        offline=dict(audio_s=idx * traffic["batch"] * n / cfg["sample_rate"],
                     window_s=window_s, chunks=idx,
                     chunk_gaps_s=[b - a for a, b in zip(times, times[1:])]),
    )

    if trace:
        path = out_dir / "trace.json"
        prof = tracing.profile(path)
        with _Wrapped(offline, cfg) as wrapped:
            prof.start()
            next(gen)  # the pipeline refills under the profiler
            for calls in wrapped.calls.values():
                calls.clear()
            with tracing.span("window"):
                for _ in range(traffic["trace_chunks"]):
                    next(gen)
                if cuda:
                    torch.cuda.synchronize(dev)
            prof.stop()
        red = tracing.reduce(path, SPANS) if cuda else None
        if red is not None:
            red.update(steps=traffic["trace_chunks"], calls=wrapped.calls)
            path.unlink()
        record["trace"] = red
    window.close()
    gen.close()
    if cuda:
        torch.cuda.synchronize(dev)
        record["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    common.write_json(out_dir / "timings.json", dict(chunk_end_s=[t - t_first for t in times]))

    # the check, on the program's outputs, with the program freed
    del gen, sep
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    record["check"] = check(cfg, cell.limits, pool, kept, checked, dev)
    record["attempted"] = idx
    return record


def compare(cfg: dict, x_i16, est: np.ndarray, targets: np.ndarray, device,
            precision: str = "float32", tie: float = 0.0):
    """Per mixture, against the reference computed in ``precision``: the gap
    of the targets (``ref.target_gaps``), the relative error of the
    estimates, and that of their sum over targets (the NMF's
    reconstruction, whatever the attribution). Where the targets differ by
    a near-tie (a gap within ``tie``), either choice is right, and the
    estimates are judged against the reference's for the targets chosen."""
    import torch

    x = torch.as_tensor(x_i16, device=device)
    want, re, mean_ang = ref.separate(x, cfg, precision)
    got = torch.as_tensor(np.asarray(targets), dtype=torch.long, device=device)
    gap = ref.target_gaps(mean_ang, want, got)
    follow = torch.nonzero((gap > 0) & (gap <= tie)).flatten()
    if follow.numel():
        re[follow] = ref.separate(x[follow], cfg, precision, targets=got[follow])[1]
    est = torch.as_tensor(est, device=device)
    err = ref.relative_errors(est, re).cpu().numpy()
    mix = ref.relative_errors(est.sum(dim=1), re.sum(dim=1)).cpu().numpy()
    return gap.cpu().numpy(), err, mix


def check(cfg: dict, limits: dict, pool, kept: dict, checked, device,
          precision: str = "float32") -> dict:
    """``correct`` and the numbers compared, each beside its limit: the
    worst target gap (a source localized wrong), the worst mixture's
    estimate error (a mixture separated wrong) and the median error of the
    estimates' sum over targets (the precision of the NMF's reconstruction,
    which no attribution flip moves)."""
    gaps, errs, mixes, missing, failed = [], [], [], 0, 0
    for p in checked:
        if p not in kept:
            missing += 1
            continue
        est, targets = kept[p]
        g, e, m = compare(cfg, pool[p], est, targets, device, precision,
                          limits["targets_gap_max"])
        gaps.extend(float(v) for v in g)
        errs.extend(float(v) for v in e)
        mixes.extend(float(v) for v in m)
        failed += int((~(g <= limits["targets_gap_max"]) | ~(e <= limits["est_err_max"])).sum())
    inf = float("inf")
    numbers = {
        "missing_chunks": (missing, 0),
        "targets_gap_max": (max(gaps) if gaps else inf, limits["targets_gap_max"]),
        "est_err_max": (max(errs) if errs else inf, limits["est_err_max"]),
        "mix_err_median": (float(np.median(mixes)) if mixes else inf, limits["mix_err_median"]),
    }
    ok = all(np.isfinite(v) and v <= lim for v, lim in numbers.values())
    return dict(correct=bool(ok), numbers=numbers, failed=failed + missing * len(pool[0]),
                errors=dict(gap=gaps, est=errs, mix=mixes))


def control(cell, seed: int, device) -> dict:
    """The check of the control, the reference one step below the
    configuration's precision (``control_precision``) put in the program's
    place, on the pool chunks that a run of ``seed`` checks."""
    import torch

    cfg, traffic = cell.config, cell.traffic
    pool, _ = make_pool(cfg, traffic, seed, device)
    rng = np.random.default_rng(seed)
    checked = sorted(int(p) for p in rng.choice(len(pool), size=min(traffic["check_pools"],
                                                                      len(pool)), replace=False))
    kept = {}
    for p in checked:
        targets, est, _ = ref.separate(torch.as_tensor(pool[p], device=device), cfg,
                                       cfg["control_precision"])
        kept[p] = (est.cpu().numpy(), targets.cpu().numpy())
    return check(cfg, cell.limits, pool, kept, checked, device)
