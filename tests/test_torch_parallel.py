"""The port's process groups (``gccnmf_torch/parallel/{mesh,launch,jobs,
nmf_sharded,trainer}.py``) on the CPU: gloo worlds of up to 4 ranks from
``launch.run_world``, against the JAX package's ``parallel/`` on the
8-device virtual mesh of tests/conftest.py at the same (data, model)
shapes, at the JAX suite's bars (tests/test_parallel.py): W within
atol = rtol = 5e-3, H within atol 5e-3 and rtol 5e-2, the trainer within
rtol 2e-3 and atol 2e-5 of the one-device NMF. One spawned world serves
every case of its size (``jobs.each``); each has a time limit."""

import json
import os
import queue
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gccnmf_tpu.parallel import mesh as jmesh
from gccnmf_tpu.parallel import nmf_sharded as jsharded
from gccnmf_tpu.parallel.trainer import DistributedNMFTrainer as JaxTrainer
from gccnmf_torch.ops import nmf
from gccnmf_torch.parallel import jobs, launch, nmf_sharded
from gccnmf_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)  # the suite runs several xdist workers

ROOT = Path(__file__).resolve().parent.parent
WORLD_S = 240  # time limit of each spawned world
T, F, K = 192, 129, 32
W_TOL = dict(atol=5e-3, rtol=5e-3)
H_TOL = dict(atol=5e-3, rtol=5e-2)
SHAPES = [(1, 1), (2, 1), (4, 1), (2, 2), (1, 4)]
SIMUL_SHAPES = [(2, 2), (1, 4)]


def _problem():
    g = np.random.default_rng(1234)
    v = (g.random((T, F)) + 0.05).astype(np.float32)
    w0, h0 = nmf.nmf_init_numpy(F, K, T)
    return v, w0, h0


def _corpus(seed, t, f):
    return (np.random.default_rng(seed).random((t, f)) + 0.05).astype(np.float32)


def _silent_frame(v):
    v = v.copy()
    v[5] = 0.0
    return v


def _nmf_call(data, model, iters=20, v=None, **kw):
    p_v, w0, h0 = _problem()
    return (jobs.sharded_nmf, (p_v if v is None else v, w0, h0, iters, data, model, "cpu"), kw)


# every call of the 4-rank world: the NMF at each 4-rank shape (data=None
# takes every rank), the turbo updates, silence, pretraining, the trainer, a
# round trip of the blocks and the mesh errors
W4_CALLS = {
    (4, 1): _nmf_call(4, 1),
    (2, 2): _nmf_call(None, 2),
    (1, 4): _nmf_call(1, 4),
    ("simul", 2, 2): _nmf_call(2, 2, 15, simultaneous=True),
    ("simul", 1, 4): _nmf_call(1, 4, 15, simultaneous=True),
    "turbo_silence": _nmf_call(2, 2, 6, v=np.zeros((T, F), np.float32), simultaneous=True),
    "silent_frame": _nmf_call(4, 1, 5, v=_silent_frame(_problem()[0])),
    "silent_frame_guarded": _nmf_call(4, 1, 5, v=_silent_frame(_problem()[0]), guard=True),
    "round_trip": _nmf_call(2, 2, 0),
    "pretrain": (jobs.on_mesh, (nmf_sharded.pretrain_dictionary_sharded, 2, 2, "cpu",
                                _problem()[0][:100], 16, 5), {}),
    "trainer": (jobs.train, (_corpus(7, 64, 33), 2, 2, "cpu"),
                dict(dictionary_size=8, num_iterations=12, checkpoint_every=5)),
    "not_divisible": (mesh_lib.make_mesh, (None, 3, "cpu"), {}),
    "exceeds": (mesh_lib.make_mesh, (5, 1, "cpu"), {}),
    "leaves_out": (mesh_lib.make_mesh, (2, 1, "cpu"), {}),
    "multihost": (mesh_lib.multihost_mesh, (3, "cpu"), {}),
    "rows_not_divisible": _nmf_call(4, 1, 1, v=_problem()[0][:190]),
}
MESH_ERRORS = {
    "not_divisible": "4 devices not divisible by model=3",
    "exceeds": "mesh 5x1 exceeds 4 devices",
    "leaves_out": "mesh 2x1 leaves 2 of 4 ranks out",
    "multihost": "model=3 must divide local device count 4",
    "rows_not_divisible": "dimension 190 not divisible by data=4",
}


@pytest.fixture(scope="module")
def w4():
    out = launch.run_world(jobs.each, 4, "cpu", list(W4_CALLS.values()), timeout_s=WORLD_S)
    return dict(zip(W4_CALLS, out))


@pytest.fixture(scope="module")
def resume_runs(tmp_path_factory):
    """Two 2-rank worlds: the NMF at (2, 1) and a 4-iteration trainer run;
    then the resume to 8, a straight 8-iteration run, and a trainer of
    another dictionary size pointed at the first run's checkpoints."""
    tmp = tmp_path_factory.mktemp("resume")
    v = _corpus(8, 32, 17)
    kw = dict(dictionary_size=4, checkpoint_every=4, checkpoint_dir=str(tmp / "ck"))
    first = launch.run_world(jobs.each, 2, "cpu", [
        _nmf_call(2, 1), (jobs.train, (v, 2, 1, "cpu"), dict(num_iterations=4, **kw))],
        timeout_s=WORLD_S)
    after_first = sorted(f for f in os.listdir(tmp / "ck") if f.endswith(".npz"))
    second = launch.run_world(jobs.each, 2, "cpu", [
        (jobs.train, (v, 2, 1, "cpu"), dict(num_iterations=8, **kw)),
        (jobs.train, (v, 2, 1, "cpu"), dict(num_iterations=8, dictionary_size=4,
                                           checkpoint_every=8,
                                           checkpoint_dir=str(tmp / "ck2"))),
        (jobs.train, (v, 2, 1, "cpu"), dict(num_iterations=8, dictionary_size=8,
                                           checkpoint_every=4,
                                           checkpoint_dir=str(tmp / "ck")))],
        timeout_s=WORLD_S)
    files = sorted(f for f in os.listdir(tmp / "ck") if f.endswith(".npz"))
    return dict(nmf=first[0], after_first=after_first, resumed=second[0], straight=second[1],
                other_size=second[2], files=files)


@pytest.fixture(scope="module")
def world_of_one():
    """The (1, 1) NMF in this process: make_mesh starts a world of one on a
    private store, with no launcher."""
    assert not dist.is_initialized()
    try:
        v, w0, h0 = _problem()
        mesh = mesh_lib.make_mesh(device="cpu")
        shape, backend = tuple(mesh.shape), dist.get_backend()
        w, h = nmf_sharded.kl_nmf_sharded(*(torch.from_numpy(x) for x in (v, w0, h0)), 20, mesh)
        return dict(shape=shape, backend=backend, nmf=(w.numpy(), h.numpy()))
    finally:
        dist.destroy_process_group()


def _port_nmf(shape, w4, resume_runs, world_of_one):
    if shape == (1, 1):
        return world_of_one["nmf"]
    if shape == (2, 1):
        return resume_runs["nmf"]
    return w4[shape]


def _hold(got, *refs):
    for ref in refs:
        np.testing.assert_allclose(got[0], np.asarray(ref[0]), **W_TOL)
        np.testing.assert_allclose(got[1], np.asarray(ref[1]), **H_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
def test_kl_nmf_sharded_matches_jax_and_kl_nmf(shape, w4, resume_runs, world_of_one):
    v, w0, h0 = _problem()
    got = _port_nmf(shape, w4, resume_runs, world_of_one)
    jax_got = jsharded.kl_nmf_sharded(
        jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0), 20,
        jmesh.make_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]]))
    alone = nmf.kl_nmf(*(torch.from_numpy(x) for x in (v, w0, h0)), 20)
    assert got[0].shape == (F, K) and got[1].shape == (T, K)
    _hold(got, jax_got, [x.numpy() for x in alone])


@pytest.mark.parametrize("shape", SIMUL_SHAPES, ids=lambda s: "%dx%d" % s)
def test_simultaneous_matches_jax_and_kl_nmf_simul(shape, w4):
    v, w0, h0 = _problem()
    got = w4[("simul", *shape)]
    jax_got = jsharded.kl_nmf_sharded(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0), 15,
                                      jmesh.make_mesh(*shape), simultaneous=True)
    alone = nmf.kl_nmf_simul(*(torch.from_numpy(x) for x in (v, w0, h0)), 15)
    _hold(got, jax_got, [x.numpy() for x in alone])


def test_turbo_on_silence_stays_finite(w4):
    w, h = w4["turbo_silence"]
    assert np.isfinite(w).all() and np.isfinite(h).all()


def test_unguarded_silent_frame_turns_w_nan_as_jax(w4):
    """A silent frame: 0/0 turns W to NaN unguarded, as JAX's sharded NMF
    does; ``guard=True`` keeps it finite."""
    v, w0, h0 = _problem()
    jax_w, _ = jsharded.kl_nmf_sharded(jnp.asarray(_silent_frame(v)), jnp.asarray(w0),
                                       jnp.asarray(h0), 5, jmesh.make_mesh(4, 1))
    assert np.isnan(np.asarray(jax_w)).any() and np.isnan(w4["silent_frame"][0]).any()
    w, h = w4["silent_frame_guarded"]
    assert np.isfinite(w).all() and np.isfinite(h).all()


def test_zero_iterations_give_the_blocks_back(w4):
    """shard_rows then gather_to_host over both axes of a (2, 2) mesh is
    the identity."""
    _, w0, h0 = _problem()
    w, h = w4["round_trip"]
    np.testing.assert_array_equal(w, w0)
    np.testing.assert_array_equal(h, h0)


def test_pad_time_matches_jax():
    v, _, h0 = _problem()
    got = nmf_sharded.pad_time(v[:100], h0[:100], 8)
    want = jsharded.pad_time(v[:100], h0[:100], 8)
    assert got[0].shape == (104, F) and got[1].shape == (104, K) and got[2] == want[2] == 100
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert nmf_sharded.pad_time(v, h0, 8)[0] is v


def test_pretrain_dictionary_sharded_unit_norm_atoms(w4):
    w = w4["pretrain"]
    want = jsharded.pretrain_dictionary_sharded(_problem()[0][:100], 16, 5, jmesh.make_mesh(2, 2))
    assert w.shape == (F, 16) and np.all(w > 0)
    np.testing.assert_allclose((w ** 2).sum(0), 1.0, rtol=1e-4)
    np.testing.assert_allclose(w, want, **W_TOL)


@pytest.mark.parametrize("case", list(MESH_ERRORS))
def test_mesh_errors(case, w4):
    err = w4[case]
    assert isinstance(err, ValueError) and MESH_ERRORS[case] in str(err), repr(err)


def test_make_mesh_starts_a_world_of_one(world_of_one):
    assert world_of_one["shape"] == (1, 1) and world_of_one["backend"] == "gloo"
    assert not dist.is_initialized()  # the fixture ended it


def test_init_distributed_single_process_noop(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert mesh_lib.init_distributed(device="cpu") == 0
    assert not dist.is_initialized()


def test_trainer_fit_matches_jax(w4, tmp_path):
    """(2, 2) with checkpoints every 5 of 12 iterations: JAX's trainer at
    the same shape, and the one-device NMF within rtol 2e-3, atol 2e-5."""
    v = _corpus(7, 64, 33)
    want = JaxTrainer(jmesh.make_mesh(2, 2), dictionary_size=8, num_iterations=12,
                      checkpoint_every=5, checkpoint_dir=str(tmp_path / "ck")).fit(v)
    w0, h0 = nmf.nmf_init_numpy(33, 8, 64)
    alone, _ = nmf.kl_nmf(*(torch.from_numpy(x) for x in (v, w0, h0)), 12)
    np.testing.assert_allclose(w4["trainer"], want, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(w4["trainer"], alone.numpy(), rtol=2e-3, atol=2e-5)


def test_trainer_resume_across_worlds(resume_runs):
    """A world stopped at 4 of 8 iterations; a new world resumes at 4 and
    equals one uninterrupted 8-iteration run."""
    assert resume_runs["after_first"] == ["nmf_000004.npz"]
    assert resume_runs["files"] == ["nmf_000004.npz", "nmf_000008.npz"]
    np.testing.assert_allclose(resume_runs["resumed"], resume_runs["straight"], rtol=1e-5)


def test_trainer_rejects_changed_dictionary_size(resume_runs):
    err = resume_runs["other_size"]
    assert isinstance(err, ValueError) and "different problem" in str(err), repr(err)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


RANK_CODE = """
import json, sys
import numpy as np
from gccnmf_torch.parallel import jobs, launch
from gccnmf_torch.parallel.trainer import DistributedNMFTrainer
v = np.load(sys.argv[1])
tr = DistributedNMFTrainer.for_deployment(model=2, device="cpu", dictionary_size=8,
                                          num_iterations=4, checkpoint_every=2,
                                          checkpoint_dir=sys.argv[2])
w = tr.fit(v)
# run_world under torchrun: this world, no spawn; rank 0's result
got = launch.run_world(jobs.each, 2, "cpu", [(len, ([1, 2, 3],), {})])
if tr.mesh.get_rank() == 0:
    np.save(sys.argv[3], w)
print(json.dumps(dict(shape=list(tr.mesh.shape), run_world=got, bad=launch.imported_forbidden())))
"""


def test_for_deployment_from_torchrun_env(tmp_path):
    """Two processes with torchrun's variables: for_deployment joins them
    (gloo) into a (1, 2) mesh and fits W, as JAX's for_deployment does
    over its devices; run_world runs in the running world."""
    v = _corpus(0, 64, 129)
    np.save(tmp_path / "v.npy", v)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: x for k, x in os.environ.items() if k != "PYTHONPATH"}
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CODE, str(tmp_path / "v.npy"), str(tmp_path / "ck"),
             str(tmp_path / "w.npy")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORLD_S)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    assert [o["shape"] for o in outs] == [[1, 2], [1, 2]]
    assert outs[0]["run_world"] == [3] and outs[1]["run_world"] is None
    assert outs[0]["bad"] == outs[1]["bad"] == []
    w = np.load(tmp_path / "w.npy")
    w0, h0 = nmf.nmf_init_numpy(129, 8, 64)
    alone, _ = nmf.kl_nmf(*(torch.from_numpy(x) for x in (v, w0, h0)), 4)
    assert w.shape == (129, 8) and np.isfinite(w).all() and (w >= 0).all()
    np.testing.assert_allclose(w, alone.numpy(), rtol=2e-3, atol=2e-5)
    assert sorted(os.listdir(tmp_path / "ck")) == ["latest", "nmf_000002.npz", "nmf_000004.npz"]


def test_run_world_reports_every_failed_rank():
    with pytest.raises(RuntimeError, match="2 of 2 ranks failed") as exc:
        launch.run_world(mesh_lib.make_mesh, 2, "cpu", 8, 1, "cpu", timeout_s=WORLD_S)
    text = str(exc.value)
    assert "--- rank 0 ---" in text and "--- rank 1 ---" in text
    assert "mesh 8x1 exceeds 2 devices" in text


def test_run_world_times_out():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out after 2"):
        launch.run_world(time.sleep, 1, "cpu", 60, timeout_s=2)
    assert time.monotonic() - t0 < 30


class _LateQueue:
    """A results queue whose first waiting ``get`` times out although the
    reports are already there: a rank that put its report and exited
    while the parent's ``get`` was timing out."""

    def __init__(self, items):
        self.items, self.waited = list(items), False

    def get(self, block=True, timeout=None):
        if block and not self.waited:
            self.waited = True
            raise queue.Empty
        if not self.items:
            raise queue.Empty
        return self.items.pop(0)


class _Exited:
    exitcode = 0


@pytest.mark.parametrize("items,want", [
    ([(0, True, [])], {0: (True, [])}),
    ([], {0: (False, "exited with code 0 before reporting")}),
], ids=["reported", "never_reported"])
def test_collect_reads_the_queue_before_failing_an_exited_rank(items, want):
    """A rank seen to have exited fails the world only if its report is not
    on the queue: one that reported and exited between a timed-out ``get``
    and the look at its exit code counts as reported."""
    assert launch._collect([_Exited()], _LateQueue(items), 5.0) == want


def test_ranks_import_neither_jax_nor_gccnmf_tpu():
    """This process imported JAX; its spawned ranks did not (each rank also
    checks it before it runs anything)."""
    assert launch.imported_forbidden()
    assert launch.run_world(launch.imported_forbidden, 2, "cpu", timeout_s=WORLD_S) == []
