"""The frozen work counts and bounds at the kernel table's shapes, and the
reduction of a traced window."""

import json

import pytest

from harness import roofline, trace

WIN, HOP, F, K, D, S = 1024, 128, 513, 128, 128, 3
T10 = 1243  # frames of 10 s at hop 128


@pytest.mark.parametrize("kernel, batch, mode, want_ms", [
    ("nmf", 16, "bfloat16_q", 2.113),
    ("synthesis", 16, "bfloat16", 0.269),
    ("frontend", 16, "bfloat16", 0.0898),
    ("nmf", 2, "float32", 3.898),
])
def test_bounds_at_the_kernel_tables_shapes(kernel, batch, mode, want_ms):
    if kernel == "nmf":
        work = roofline.nmf_work(batch, 2 * T10, F, K, 100, mode, 2 if mode != "float32" else 4)
    elif kernel == "synthesis":
        work = roofline.synthesis_work(batch, S, T10, F, K, WIN, HOP, mode, 2)
    else:
        work = roofline.frontend_work(batch, 160000, T10, F, D, WIN, mode, 2)
    ms, by = roofline.bound(*work, mode)
    assert ms == pytest.approx(want_ms, rel=2e-3)  # the table gives 3–4 digits
    assert by == "operations"


def test_span_share_is_least_time_over_device_time():
    flops, nbytes = roofline.nmf_work(16, 2 * T10, F, K, 100, "bfloat16_q", 2)
    rec = {"trace": {"calls": {"nmf": [(flops, nbytes, "bfloat16_q")] * 2},
                     "device_s_by_span": {"nmf": 2 * 0.036981}}}
    assert roofline.span_share(rec, "nmf") == pytest.approx(100 * 2.113 / 36.981, rel=1e-3)
    assert roofline.span_share(rec, "synthesis") is None
    assert roofline.span_share({}, "nmf") is None


def test_reduce_attributes_device_time_to_the_launching_span(tmp_path):
    ev = [
        dict(ph="X", cat="user_annotation", name="portbench.window", ts=100, dur=100, tid=1),
        dict(ph="X", cat="user_annotation", name="portbench.nmf", ts=110, dur=20, tid=1),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=112, dur=2, tid=1,
             args=dict(correlation=1)),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=150, dur=2, tid=1,
             args=dict(correlation=2)),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=90, dur=2, tid=1,
             args=dict(correlation=3)),
        dict(ph="X", cat="cpu_op", name="aten::mul", ts=160, dur=30, tid=1),
        dict(ph="X", cat="kernel", name="k_nmf", ts=120, dur=30, args=dict(correlation=1,
                                                                            device=0)),
        dict(ph="X", cat="kernel", name="k_other", ts=150, dur=5, args=dict(correlation=2,
                                                                             device=0)),
        dict(ph="X", cat="gpu_memcpy", name="copy", ts=100, dur=4, args=dict(correlation=3,
                                                                             device=0)),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = trace.reduce(path, ("nmf",))
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(39e-6)  # 100-104, 120-150, 150-155
    assert r["device_s_by_span"] == {"nmf": pytest.approx(30e-6)}
    assert r["device_s_outside_spans"] == pytest.approx(5e-6)  # the copy predates the window
    assert r["kernels"] == 2
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::mul"] == pytest.approx(45e-6)  # 155-200: the op spans its middle
    assert gaps["cudaLaunchKernel"] == pytest.approx(16e-6)  # 104-120: the launch at 112
