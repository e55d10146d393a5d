"""The port's copy of the host-heap trim policy and the RssAnon watchdog
(gccnmf_torch/utils/hostmem.py), pinned as tests/test_hostmem.py pins the
JAX package's."""

import numpy as np

from gccnmf_torch.utils.hostmem import (
    HostMemWatchdog, PeriodicTrim, rss_anon_mib, trim_host_heap,
)


def test_trim_callable_and_reports_support():
    ok = trim_host_heap()  # True on glibc; False, never raising, elsewhere
    assert isinstance(ok, bool)
    assert trim_host_heap() == ok  # calling twice is safe


def test_periodic_trim_fires_at_threshold_and_resets():
    tr = PeriodicTrim(every_bytes=100)
    assert not tr.account(60)
    fired = tr.account(60)  # crosses 100
    assert fired == (tr.trims == 1)
    assert not tr.account(60)  # the counter reset


def test_periodic_trim_accumulates_small_chunks():
    tr = PeriodicTrim(every_bytes=1000)
    assert not any(tr.account(100) for _ in range(9))
    tr.account(100)
    assert tr.trims in (0, 1)  # 1 on glibc, 0 where unsupported
    assert PeriodicTrim().every_bytes == 256 * 1024 * 1024


def test_periodic_trim_over_a_chunk_stream():
    """separate_batches accounts every chunk in and out: 40 chunks of a
    16-utterance 10 s int16 batch (10.2 MB each) fire at least one trim."""
    tr = PeriodicTrim()
    chunk = np.zeros((16, 2, 160000), np.int16)
    for _ in range(40):
        tr.account(chunk.nbytes)
    assert tr._since < tr.every_bytes
    if trim_host_heap():
        assert tr.trims >= 1


def test_watchdog_reports_against_budget_and_rate_limits():
    samples = iter([100.0, 100.0, 7000.0])
    clock = [0.0]
    wd = HostMemWatchdog(budget_mib=6144.0, min_interval_s=10.0, _now=lambda: clock[0],
                         _sample=lambda: next(samples))
    assert wd.baseline_mib == 100.0
    assert wd.check() == {"anon_mib": 100.0, "budget_mib": 6144.0, "exceeded": False}
    assert wd.check()["anon_mib"] == 100.0  # the same instant: no new sample
    clock[0] = 11.0
    st = wd.check()
    assert st["exceeded"] is True and st["anon_mib"] == 7000.0


def test_real_sample_on_linux():
    assert rss_anon_mib() > 1.0  # a live CPython process has anonymous RSS
