"""Entry of offline enhancement cells: ``GCCNMFEnhancer.enhance_batches``
over an endless stream of equal chunks, with a pre-learned dictionary.

Set-up: import the port, make the dictionary and a pool of distinct int16
chunks from the seed (on the device), build the enhancer, push one chunk
through the pipelined entry (which loads the kernels' library, building it
in a fresh checkout), then ``gc.collect()`` and ``gc.freeze()``.

Window: the entry runs over the pool, cycled. It opens at the first chunk
yielded and closes at the first chunk yielded ``seconds`` later, and not
before as many chunks as the pool holds (so that every pool chunk the
check reads has run); the audio of the chunks
after the first, over that time, is the rate. The record keeps it under
``offline``, where the offline readers look.

Traced run (``trace``): the untraced window, then ``trace_chunks`` more
chunks of the same generator under the profiler, the three kernel
wrappers that ``models/offline.py`` binds for the enhancer wrapped in
harness spans, each call's work counted from its arguments
(``harness/roofline.py``, ``harness/roofline_enhance.py``), and the
program's own ``gccnmf.*`` spans reduced (``harness/program_trace.py``).

Check: once the window has closed and the program is freed, the last
output of each of ``check_pools`` pool chunks (drawn from the seed) is
compared with the plain reference (``reference/offline_enhance.py``) on
the same int16 input and dictionary, by the numbers of :func:`check`, each
against the cell's limit in ``limits/<cell>.json``.

Traffic: each mixture holds one voiced talker at a seeded integer delay
inside the pair's largest TDOA, and background noise at a seeded SNR:
weaker voiced talkers (babble) at other delays and noise uncorrelated
between the two microphones.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from harness import common, program_trace, roofline, roofline_enhance, signals
from harness import trace as tracing
from reference import offline_enhance as ref
from reference.offline_gccnmf import SPEED_OF_SOUND_M_S

SPANS = ("frontend", "soft_mask", "tf_synthesis")
WRAPPED = {"frontend": "stft_gcc_frontend_cuda", "soft_mask": "soft_mask_cuda",
           "tf_synthesis": "tf_synthesis_cuda"}


def make_dictionary(cfg: dict, g, device):
    """A seeded nonnegative (F, K) dictionary with unit-norm atoms, in
    place of a pretrained one: cubed uniform draws, so each atom has a
    spectral shape of its own, over a floor that keeps every bin's sum
    positive."""
    import torch

    f = cfg["window_size"] // 2 + 1
    w = torch.rand((f, cfg["dictionary_size"]), generator=g, device=device) ** 3 + 1e-3
    return w / w.norm(dim=0, keepdim=True)


def _delayed(src, delays, n: int, pad: int):
    """``(batch, count, n + 2·pad)`` sources → ``(batch, 2, n)``: their sum on
    the first microphone and, ``delays`` samples later, on the second."""
    import torch

    batch, count, _ = src.shape
    left = src[..., pad:pad + n].sum(dim=1)
    idx = torch.arange(n, device=src.device) + pad
    right = torch.gather(src, 2, (idx[None, None, :] - delays[..., None]).expand(batch, count, n))
    return torch.stack([left, right.sum(dim=1)], dim=1)


def _rms(x):
    return x.pow(2).mean(dim=(1, 2), keepdim=True).sqrt().clamp(min=1e-12)


def noisy_mixtures(g, traffic: dict, n: int, sample_rate: int, max_delay: int, device):
    """``batch`` int16 stereo mixtures ``(batch, 2, n)``: a talker at a delay
    in [−max_delay, max_delay], babble talkers at other delays (gains from
    ``babble_gain``), and noise uncorrelated between the channels, the
    babble taking ``babble_share`` of the noise's power, the whole noise at
    an SNR drawn from ``snr_db``. They peak at half of full scale."""
    import torch

    b, nb = traffic["batch"], traffic["babble_talkers"]
    span = 2 * max_delay + 1
    target = torch.randint(0, span, (b, 1), generator=g, device=device)
    # the babble's delays: distinct offsets from the target's, wrapped
    offsets = torch.argsort(torch.rand((b, span - 1), generator=g, device=device), dim=1)
    others = (target + 1 + offsets[:, :nb]) % span
    delays = torch.cat([target, others], dim=1) - max_delay
    lo, hi = traffic["babble_gain"]
    gains = torch.cat([torch.ones((b, 1), device=device),
                       lo + (hi - lo) * torch.rand((b, nb), generator=g, device=device)], dim=1)
    src = signals.talkers(g, b * (1 + nb), n + 2 * max_delay, sample_rate, device)
    src = src.reshape(b, 1 + nb, -1) * gains[..., None]
    speech = _delayed(src[:, :1], delays[:, :1], n, max_delay)
    babble = _delayed(src[:, 1:], delays[:, 1:], n, max_delay)
    diffuse = torch.randn((b, 2, n), generator=g, device=device)
    share = traffic["babble_share"]
    noise = share ** 0.5 * babble / _rms(babble) + (1 - share) ** 0.5 * diffuse / _rms(diffuse)
    lo, hi = traffic["snr_db"]
    snr = lo + (hi - lo) * torch.rand((b, 1, 1), generator=g, device=device)
    mix = speech + noise * _rms(speech) * 10.0 ** (-snr / 20.0)
    mix = 0.5 * mix / mix.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-6)
    return torch.round(mix * 32767.0).to(torch.int16)


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    """The dictionary ((F, K) on ``device``), ``pool`` int16 chunks (B, 2, n)
    on the host, made on ``device``, and n."""
    g = signals.generator(seed, device)
    w = make_dictionary(cfg, g, device)
    sr = cfg["sample_rate"]
    n = int(round(traffic["seconds_per_mixture"] * sr))
    max_delay = int(cfg["mic_separation_m"] / SPEED_OF_SOUND_M_S * sr)
    pool = [noisy_mixtures(g, traffic, n, sr, max_delay, device).cpu().numpy()
            for _ in range(traffic["pool"])]
    return w, pool, n


def offline_config(cfg: dict):
    from gccnmf_torch.models.offline import OfflineConfig

    keys = ("window_size", "hop_size", "num_tdoas", "mic_separation_m", "dictionary_size",
            "sample_rate", "nmf_matmul_dtype", "epsilon")
    return OfflineConfig(**{k: cfg[k] for k in keys})


def _work(name: str, cfg: dict, args, kwargs, out):
    """(flops, bytes, mode) of one wrapper call, from its arguments."""
    win = cfg["window_size"]
    mode = kwargs["matmul_dtype"]
    if name == "frontend":
        x, ang = args[0], out[5]
        plane = 2 if kwargs.get("plane_dtype") == "bfloat16" else 4
        flops, nbytes = roofline.frontend_work(x.shape[0], x.shape[-1], ang.shape[-2],
                                               win // 2 + 1, ang.shape[-1], win, mode, plane)
    elif name == "soft_mask":
        cre, cw = args[0], args[2][0]
        d, f, k = cw.shape
        flops, nbytes = roofline_enhance.soft_mask_work(cre.shape[0], cre.shape[1], f, d, k,
                                                        mode, cre.element_size())
    else:
        sre, wn = args[0], args[3][0]
        b, c, t = sre.shape[:3]
        k, f = wn.shape
        flops, nbytes = roofline_enhance.tf_synthesis_work(b, c, t, f, k, win,
                                                           kwargs["hop_size"], mode,
                                                           sre.element_size())
    return flops, nbytes, mode


class _Wrapped:
    """The enhancer's three kernel wrappers in ``models/offline.py`` in
    harness spans, their work recorded per call, while the context is
    open."""

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
    from gccnmf_torch.models.offline import GCCNMFEnhancer

    GCCNMFEnhancer.enhance_batches  # noqa: B018  a program without it fails here, at once
    cfg, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    w, pool, n = make_inputs(cfg, traffic, seed, device)
    enh = GCCNMFEnhancer(w.cpu().numpy(), offline_config(cfg),
                         target_epsilon=cfg["target_epsilon"], target_beta=cfg["target_beta"],
                         noise_floor=cfg["noise_floor"], num_h_updates=cfg["num_h_updates"],
                         device=device)
    dev = enh.device
    io = cfg["io_dtype"]
    for _ in enh.enhance_batches([pool[0]], io_dtype=io):  # warm this cell's shapes
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
    gen = enh.enhance_batches(endless(), io_dtype=io)
    next(gen)
    t_first = time.perf_counter()
    times, idx = [t_first], 0
    while True:
        out, targets = next(gen)
        idx += 1
        times.append(time.perf_counter())
        if idx % pools in checked:
            kept[idx % pools] = (out, targets)
        if times[-1] - t_first >= seconds and idx >= pools:
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
            red.update(steps=traffic["trace_chunks"], calls=wrapped.calls,
                       program=program_trace.reduce(path))
            path.unlink()
        record["trace"] = red
    window.close()
    gen.close()
    if cuda:
        torch.cuda.synchronize(dev)
        record["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    common.write_json(out_dir / "timings.json", dict(chunk_end_s=[t - t_first for t in times]))

    # the check, on the program's outputs, with the program freed
    del gen, enh
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    record["check"] = check(cfg, cell.limits, pool, w, kept, checked, dev)
    record["attempted"] = idx
    return record


def compare(cfg: dict, x_i16, w, out: np.ndarray, targets: np.ndarray, device,
            precision: str = "float32", tie: float = 0.0):
    """Per mixture, against the reference computed in ``precision``: the gap
    of the target (``ref.target_gaps``) and the relative error of the
    enhanced stereo output. Where the targets differ by a near-tie (a gap
    within ``tie``), either choice is right, and the output is judged
    against the reference's for the target chosen."""
    import torch

    x = torch.as_tensor(x_i16, device=device)
    want, ref_out, mean_ang = ref.enhance(x, cfg, w, precision)
    got = torch.as_tensor(np.asarray(targets), dtype=torch.long, device=device)
    gap = ref.target_gaps(mean_ang, want, got)
    follow = torch.nonzero((gap > 0) & (gap <= tie)).flatten()
    if follow.numel():
        ref_out[follow] = ref.enhance(x[follow], cfg, w, precision, targets=got[follow])[1]
    err = ref.relative_errors(torch.as_tensor(out, device=device), ref_out)
    return gap.cpu().numpy(), err.cpu().numpy()


def check(cfg: dict, limits: dict, pool, w, kept: dict, checked, device,
          precision: str = "float32") -> dict:
    """``correct`` and the numbers compared, each beside its limit: the
    worst target gap (a mixture enhanced around the wrong TDOA), the worst
    mixture's output error (a mixture enhanced wrong) and the median
    mixture's output error (the precision of the whole path)."""
    gaps, errs, missing, failed = [], [], 0, 0
    for p in checked:
        if p not in kept:
            missing += 1
            continue
        out, targets = kept[p]
        g, e = compare(cfg, pool[p], w, out, targets, device, precision,
                       limits["target_gap_max"])
        gaps.extend(float(v) for v in g)
        errs.extend(float(v) for v in e)
        failed += int((~(g <= limits["target_gap_max"]) | ~(e <= limits["enh_err_max"])).sum())
    inf = float("inf")
    numbers = {
        "missing_chunks": (missing, 0),
        "target_gap_max": (max(gaps) if gaps else inf, limits["target_gap_max"]),
        "enh_err_max": (max(errs) if errs else inf, limits["enh_err_max"]),
        "enh_err_median": (float(np.median(errs)) if errs else inf, limits["enh_err_median"]),
    }
    ok = all(np.isfinite(v) and v <= lim for v, lim in numbers.values())
    return dict(correct=bool(ok), numbers=numbers, failed=failed + missing * len(pool[0]),
                errors=dict(gap=gaps, err=errs))


def control(cell, seed: int, device) -> dict:
    """The check of the control, the reference one step below the
    configuration's precision (``control_precision``) put in the program's
    place, on the pool chunks that a run of ``seed`` checks."""
    import torch

    cfg, traffic = cell.config, cell.traffic
    w, pool, _ = make_inputs(cfg, traffic, seed, device)
    rng = np.random.default_rng(seed)
    checked = sorted(int(p) for p in rng.choice(len(pool), size=min(traffic["check_pools"],
                                                                      len(pool)), replace=False))
    kept = {}
    for p in checked:
        targets, out, _ = ref.enhance(torch.as_tensor(pool[p], device=device), cfg, w,
                                      cfg["control_precision"])
        kept[p] = (out.cpu().numpy(), targets.cpu().numpy())
    return check(cfg, cell.limits, pool, w, kept, checked, device)
