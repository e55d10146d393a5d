"""The frozen work counts of kernels 4 and 5 at the kernel table's shapes:
each call's least time against the table's ``bound_ms``."""

import pytest

from harness import roofline, roofline_enhance

WIN, HOP, F, K, D = 1024, 128, 513, 128, 128
T10 = 1243  # frames of 10 s at hop 128


@pytest.mark.parametrize("kernel, batch, mode, want_ms, by", [
    ("soft_mask", 16, "bfloat16", 0.676, "operations"),
    ("tf_synthesis", 16, "bfloat16", 0.0871, "operations"),
    ("soft_mask", 2, "float32", 0.631, "operations"),
    ("tf_synthesis", 2, "float32", 0.0073, "bytes"),
])
def test_bounds_at_the_kernel_tables_shapes(kernel, batch, mode, want_ms, by):
    plane = 4 if mode == "float32" else 2
    if kernel == "soft_mask":
        work = roofline_enhance.soft_mask_work(batch, T10, F, D, K, mode, plane)
    else:
        work = roofline_enhance.tf_synthesis_work(batch, 2, T10, F, K, WIN, HOP, mode, plane)
    ms, bound_by = roofline.bound(*work, mode)
    assert ms == pytest.approx(want_ms, rel=2e-3)  # the table gives 3–4 digits
    assert bound_by == by


def test_the_cells_soft_mask_is_16_tflop_a_chunk():
    """16 mixtures of 60 s (T = 7,493) at D = 64, K = 1,024: 16.1 TFLOP of
    scores, 16.3 ms at the bf16 peak."""
    flops, _ = roofline_enhance.soft_mask_work(16, 7493, F, 64, 1024, "bfloat16", 2)
    assert flops == pytest.approx(16.1e12, rel=3e-3)
    assert roofline.bound(flops, 0, "bfloat16")[0] == pytest.approx(16.3, rel=3e-3)
