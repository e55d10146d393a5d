"""The port's native host runtime (``gccnmf_torch/native``) against JAX's
(``gccnmf_tpu/native``) on the same seeded arrays, bit for bit: the PCM16
conversions, (de)interleave, the SPSC ring across a wrap, host overlap-add
and the block-time ring. Each case runs twice: through the port's compiled
library, and with its loader patched to find none, through its NumPy path.
JAX's side always runs its compiled library. The bars are
tests/test_native.py's."""

import threading
from pathlib import Path

import numpy as np
import pytest

from gccnmf_tpu import native as jnative
from gccnmf_torch import native
from gccnmf_torch.native import build as native_build
from gccnmf_torch.native import runtime as rt

PATHS = ["compiled", "numpy"]


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """Which of the port's two paths runs: ``numpy`` patches the loader to
    find no library."""
    if request.param == "numpy":
        monkeypatch.setattr(rt, "_load", lambda: None)
    else:
        assert native.available()
    assert jnative.available()
    return request.param


def _uses(obj, path):
    assert (obj._lib is None) == (path == "numpy")


def test_library_builds_into_the_build_dir():
    """One g++ build, into gccnmf_torch/build/ under a name of the port's
    own (hash of source and compiler), and nothing next to the source."""
    compiler = native_build.find_compiler()
    assert compiler is not None and native.available()
    lib = Path(native_build.lib_path(compiler))
    assert lib.exists() and lib.parent == native_build.BUILD_DIR
    assert lib.name.startswith("libgccnmf_torch_rt_")
    assert native_build.BUILD_DIR == Path(native_build.__file__).resolve().parent.parent / "build"
    src_dir = native_build.SRC.parent
    assert sorted(p.name for p in src_dir.iterdir()) == ["gccnmf_rt.cpp"]
    assert not list(src_dir.parent.glob("*.so*"))
    assert native_build.build() == str(lib)  # built once, then found


def test_source_is_jax_source():
    """The C++ source is JAX's, line for line apart from one comment."""
    ours = native_build.SRC.read_text().splitlines()
    theirs = (Path(jnative.__file__).parent / "src" / "gccnmf_rt.cpp").read_text().splitlines()
    assert len(ours) == len(theirs)
    differ = [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b]
    assert all(ours[i].startswith("//") for i in differ) and len(differ) <= 2


@pytest.mark.parametrize("n", [1, 4097])
def test_pcm16_to_float_matches_jax(path, n):
    pcm = np.random.default_rng(0).integers(-32768, 32768, size=n, dtype=np.int16)
    got = native.pcm16_to_float(pcm)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative.pcm16_to_float(pcm))
    np.testing.assert_array_equal(got, pcm.astype(np.float32) / 32768.0)


def test_float_to_pcm16_matches_jax_and_wav(path):
    """One float→PCM convention (x·2^15, clip, truncate) for the native
    tier, the port's WAV writer and JAX."""
    from gccnmf_torch.utils import wav as wavio

    edges = np.array([-2.0, -1.0, -0.5, 0.0, 0.25, 1.0, 2.0], np.float32)
    np.testing.assert_array_equal(native.float_to_pcm16(edges),
                                  [-32768, -32768, -16384, 0, 8192, 32767, 32767])
    y = np.random.default_rng(3).uniform(-1.2, 1.2, (2, 4096)).astype(np.float32)
    got = native.float_to_pcm16(y)
    np.testing.assert_array_equal(got, jnative.float_to_pcm16(y))
    np.testing.assert_array_equal(got, wavio.float_to_pcm(y, "int16"))


@pytest.mark.parametrize("channels,count", [(2, 1024), (2, 1023), (3, 999)])
def test_deinterleave_matches_jax(path, channels, count):
    """Interleaved int16 → planar float32, a ragged tail truncated."""
    pcm = np.random.default_rng(4).integers(-32768, 32768, size=count, dtype=np.int16)
    got = native.deinterleave_pcm16(pcm, channels)
    assert got.shape == (channels, count // channels)
    np.testing.assert_array_equal(got, jnative.deinterleave_pcm16(pcm, channels))


def test_interleave_matches_jax_and_round_trips(path):
    planar = np.random.default_rng(1).uniform(-1.1, 1.1, size=(2, 512)).astype(np.float32)
    inter = native.interleave_pcm16(planar)
    assert inter.shape == (1024,) and inter.dtype == np.int16
    np.testing.assert_array_equal(inter, jnative.interleave_pcm16(planar))
    back = native.deinterleave_pcm16(inter, 2)
    inside = np.abs(planar) < 1.0
    np.testing.assert_allclose(back[inside], planar[inside], atol=1.5 / 32768)


@pytest.mark.parametrize("capacity", [64, 100, 1000])
def test_spsc_ring_across_wrap_matches_jax(path, capacity):
    """The same writes and reads through both rings, wrapping many times:
    the same usable capacity, accepted counts and samples."""
    ring, ref = rt.SpscRing(capacity), jnative.SpscRing(capacity)
    _uses(ring, path)
    assert ring.capacity == ref.capacity
    rng = np.random.default_rng(capacity)
    for rep in range(30):
        chunk = rng.standard_normal(int(rng.integers(1, 2 * capacity))).astype(np.float32)
        assert ring.write(chunk) == ref.write(chunk)
        assert ring.readable() == ref.readable() and ring.writable() == ref.writable()
        n = int(rng.integers(0, 2 * capacity))
        np.testing.assert_array_equal(ring.read(n), ref.read(n))
    np.testing.assert_array_equal(ring.read(10 * capacity), ref.read(10 * capacity))
    assert ring.readable() == 0


def test_spsc_ring_threaded_stream_integrity(path):
    """Producer streams a counter; the consumer sees it gap-free."""
    total = 100_000
    ring = rt.SpscRing(4096)
    _uses(ring, path)
    src = np.arange(total, dtype=np.float32)
    received = []

    def producer():
        pos = 0
        while pos < total:
            pos += ring.write(src[pos: pos + 512])

    t = threading.Thread(target=producer)
    t.start()
    got = 0
    while got < total:
        out = ring.read(512)
        if out.size:
            received.append(out)
            got += out.size
    t.join()
    np.testing.assert_array_equal(np.concatenate(received), src)


@pytest.mark.parametrize("channels,block,hop,frame,wpb,blocks", [
    (2, 512, 128, 1024, 4, 8), (2, 512, 256, 512, 2, 8), (1, 128, 64, 256, 2, 4),
])
def test_overlap_add_matches_jax(path, channels, block, hop, frame, wpb, blocks):
    ola, ref = rt.OverlapAdd(channels, block, blocks), jnative.OverlapAdd(channels, block, blocks)
    _uses(ola, path)
    rng = np.random.default_rng(2)
    for _ in range(12):
        frames = rng.standard_normal((channels, wpb, frame)).astype(np.float32)
        ola.add_block(frames, hop)
        ref.add_block(frames, hop)
        np.testing.assert_array_equal(ola.emit_block(), ref.emit_block())


def test_overlap_add_rejects_oversized_span(path):
    ola = rt.OverlapAdd(1, 128, 4)  # the ring holds 512 samples
    with pytest.raises(ValueError, match="ring holds"):
        ola.add_block(np.zeros((1, 2, 512), np.float32), 64)


def test_block_times_match_jax(path):
    """stats, snapshot and percentiles equal JAX's, empty, partly filled
    and past the window (tests/test_native.py holds the NumPy path's stats
    with pytest.approx)."""
    bt, ref = rt.BlockTimes(capacity=8), jnative.BlockTimes(capacity=8)
    _uses(bt, path)
    assert bt.stats() == ref.stats() == (0.0, 0.0, 0.0, 0)
    assert bt.snapshot().size == 0 and bt.percentiles() == (0.0, 0.0)
    rng = np.random.default_rng(5)
    for n in (3, 13):
        for v in rng.uniform(0.001, 0.05, n):
            bt.record(v)
            ref.record(v)
        (mn, mx, mean, held), want = bt.stats(), ref.stats()
        # min, max and count exact; the mean's sum in another order on the
        # NumPy path (pairwise), so to its last bits
        assert (mn, mx, held) == (want[0], want[1], want[3])
        assert mean == pytest.approx(want[2], rel=1e-12)
        np.testing.assert_array_equal(np.sort(bt.snapshot()), np.sort(ref.snapshot()))
        assert bt.percentiles((50.0, 99.0)) == ref.percentiles((50.0, 99.0))
    assert bt.stats()[3] == 8


def test_serving_and_blocktimes_use_the_native_ring():
    """The server records into the native tier's ring, and the old module
    name still imports it."""
    from gccnmf_torch import serving
    from gccnmf_torch.utils.blocktimes import BlockTimes

    assert serving.BlockTimes is BlockTimes is rt.BlockTimes
