"""The port's mesh paths (``ur_mvo_tpu_torch.parallel``: ``mesh``,
``dist_ba``, ``dist_matching``, ``MultiSequenceVO(mesh=)``,
``Backend.global_optimize(mesh=)``, ``train_step.make_dp_train_step``) at
world 2 over gloo on the CPU, against the JAX package on ``make_mesh(2)`` of the 8 virtual CPU devices
and against the port's own unsharded calls.

One world of two ranks serves the whole module: the module fixture writes
the inputs to a file, starts both ranks (``python -m
tests.test_torch_parallel DIR RANK WORLD``: a rank imports the port and
never JAX, so this file imports JAX only inside the functions the pytest
process runs), computes the references while they run, and reads each
rank's results back from its file. A rank that fails or outlives its
deadline fails every case that reads it.

Tolerances: ``tests/test_parallel.py``'s for the BA (poses 1e-3, equal
inlier counts: shard order changes the summation path); matches and the
oracle lanes bit for bit (each lane's work is its own); the neural lanes'
banks at ``tests/test_torch_multi_seq.py``'s batched-lane tolerance (the
CPU convolution blocks by batch); ``global_optimize`` 1e-3; the
data-parallel train step's at its test.
"""

import functools
import os
import pickle
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.models.superglue import SuperGlue
from ur_mvo_tpu_torch.ops.ba import BAConfig, bundle_adjust
from ur_mvo_tpu_torch.ops.matching import decode_assignment
from ur_mvo_tpu_torch.parallel import mesh as tmesh
from ur_mvo_tpu_torch.parallel.dist_ba import dist_bundle_adjust, shard_problem
from ur_mvo_tpu_torch.parallel.dist_matching import make_batched_matcher
from ur_mvo_tpu_torch.parallel.multi_seq import MultiSequenceVO, stack_lanes
from ur_mvo_tpu_torch.runtime import backend as backend_mod
from ur_mvo_tpu_torch.runtime.backend import Backend
from ur_mvo_tpu_torch.runtime.extractor import OracleExtractor
from ur_mvo_tpu_torch.models import train_superpoint as train_sp
from ur_mvo_tpu_torch.models.superpoint import SuperPoint
from ur_mvo_tpu_torch.parallel.train_step import make_dp_train_step
from ur_mvo_tpu_torch.weights import ba_problem_from_numpy, feature_bank_from_numpy, superglue_from_numpy
from tests.torch_mesh_util import CAM, make_drifted_map, one_rank_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RANK_DEADLINE_S = 150
ORACLE_S, ORACLE_FRAMES = 2, 16
NEURAL_H, NEURAL_W = 128, 160
# a gather's test pattern: signed zeros, a NaN with a payload, ordinary values
BITS = np.array([0x80000000, 0x7FC00001, 0x00000000, 0x3F800000], np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# Shared by the ranks and the pytest process (the port only)
# ---------------------------------------------------------------------------

def _oracle_cfg():
    """``tests/test_torch_multi_seq.py``'s oracle lanes' configuration."""
    cfg = tconfig.Configs()
    cfg.superpoint.capacity = 512
    cfg.superpoint.max_keypoints = 512
    cfg.backend.window_opt_frames = 8
    cfg.backend.window_fixed_frames = 6
    cfg.backend.ba_max_points = 512
    cfg.backend.ba_max_observations = 4096
    cfg.backend.ba_iterations_phase1 = 6
    cfg.backend.ba_iterations_phase2 = 3
    return cfg


def _oracle_run(inp, mesh):
    """The oracle lanes' banks through ``process_banks`` (mutual-NN batched
    match, batched track): every frame's poses and the trajectories."""
    cam = make_pinhole(640, 512, 400.0, 400.0, 320.0, 256.0)
    ext = [OracleExtractor(X, cam, capacity=512, noise_px=0.2, seed=20 + s, device="cpu")
           for s, X in enumerate(inp["X"])]
    msvo = MultiSequenceVO(_oracle_cfg(), cam, ORACLE_S, mesh=mesh, device="cpu")
    poses = [msvo.process_banks(stack_lanes([e.extract_with_pose(g[i]) for e, g in zip(ext, inp["gts"])]),
                                [inp["ts"][i]] * ORACLE_S) for i in range(ORACLE_FRAMES)]
    return poses, msvo.trajectories()


def _neural_run(mesh):
    """Random SuperPoint / SuperGlue (the configuration's seed) on two
    random frames of two lanes: the lanes' poses and init banks."""
    cfg = _oracle_cfg()
    cfg.superpoint.capacity, cfg.superpoint.max_keypoints, cfg.superglue.num_layers = 256, 200, 1
    msvo = MultiSequenceVO(cfg, make_pinhole(NEURAL_W, NEURAL_H, 100.0, 100.0, NEURAL_W / 2, NEURAL_H / 2), 2,
                           mesh=mesh, device="cpu")
    imgs = np.random.default_rng(0).random((2, NEURAL_H, NEURAL_W)).astype(np.float32)
    poses = [msvo.process_batch(imgs, [i * 0.033] * 2) for i in range(2)]
    return poses, {i: tuple(f.numpy() for f in t._init_bank) for i, t in zip(msvo.lanes, msvo.trackers)}


def _backend(inp, **kw):
    store = pickle.loads(inp["store"])
    return Backend(make_pinhole(*inp["cam"]), tconfig.BackendConfig(**inp["bcfg"]), tconfig.OptimizationConfig(),
                   store=store, keypoints_per_frame=store.cfg.keypoints_per_frame, device="cpu", **kw)


def _global_run(inp, mesh):
    """``global_optimize`` on the drifted map with its full BA pinned to
    the float32 ``"scatter"`` assembly (a mesh's default is each shard's
    bf16 point side), so that the mesh and the single device differ only
    in the order of their sums: the store's poses and points."""
    b = _backend(inp)
    with mock.patch.object(backend_mod, "BAConfig", functools.partial(BAConfig, assembly="scatter")):
        b.global_optimize(mesh=mesh)
    return {**{f: getattr(b.store, f).copy() for f in ("kf_R", "kf_t", "mp_pos")}, "full_ba": b.last_full_ba}


def _dp_step(inp, mesh):
    """One descriptor fine-tuning step on ``inp``'s batch: through
    ``make_dp_train_step`` on ``mesh``, or the single-process step without
    one. The loss, and the descriptor head's gradients and parameters after
    the step."""
    model = SuperPoint()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in inp["sp"].items()})
    opt = train_sp.make_optimizer(model)
    step = train_sp.make_train_step(opt) if mesh is None else make_dp_train_step(opt, mesh)
    loss = step(model, {k: torch.from_numpy(v) for k, v in inp["dp_batch"].items()})
    head = {n: p for n, p in model.named_parameters() if p.requires_grad}
    return {"loss": float(loss), "params": {n: p.detach().numpy().copy() for n, p in head.items()},
            "grads": {n: p.grad.numpy().copy() for n, p in head.items()}}


def _rank_main(workdir, rank, world):
    """One rank: every case on the mesh, its results pickled to
    ``rank{rank}.pkl``."""
    torch.set_num_threads(1)
    tmesh.init_distributed("gloo", init_method=f"file://{workdir}/rendezvous", world_size=world, rank=rank,
                           device="cpu", timeout=60)
    mesh = tmesh.make_mesh(world)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"rank": rank}
    local = torch.from_numpy(BITS[rank * 2 : rank * 2 + 2].copy()).view(torch.float32)
    flags = torch.tensor([rank == 0, rank == 1])
    out["gather_bits"] = tmesh.gather_batch(local, mesh).view(torch.int32).numpy()
    out["gather_flags"] = tmesh.gather_batch(flags, mesh).numpy()
    out["replicate"] = tmesh.replicate(torch.full((3,), float(rank)), mesh).numpy()

    out["ba"] = {}
    for name, (fields, geom) in inp["ba"].items():
        prob_s, perm = shard_problem(ba_problem_from_numpy(fields), world)
        before = dict(tmesh.ALL_SUM)
        res = dist_bundle_adjust(prob_s, mesh, *geom)
        X = torch.empty_like(res.X).index_put_((torch.from_numpy(perm),), res.X)
        out["ba"][name] = {"R": res.R_wc.numpy(), "t": res.t_wc.numpy(), "X": X.numpy(),
                           "inliers": int(res.obs_inlier.sum()), "cost": float(res.cost),
                           "all_sum": tuple(tmesh.ALL_SUM[k] - before.get(k, 0) for k in ("calls", "bytes"))}

    sg = SuperGlue.from_state_dict(superglue_from_numpy(inp["sg"])).eval()
    match = make_batched_matcher(sg, mesh, 640, 512, sinkhorn_iterations=20, threshold=0.1)
    m = match(feature_bank_from_numpy(inp["banks0"]), feature_bank_from_numpy(inp["banks1"]))
    out["match"] = tuple(f.numpy() for f in m)

    try:
        MultiSequenceVO(_oracle_cfg(), make_pinhole(640, 512, 400.0, 400.0, 320.0, 256.0), 3, mesh=mesh,
                        device="cpu")
        out["odd_S"] = "built"
    except ValueError as e:
        out["odd_S"] = str(e)
    out["oracle"] = _oracle_run(inp, mesh)
    out["neural"] = _neural_run(mesh)

    out["global"] = _global_run(inp, mesh)
    out["dp"] = _dp_step(inp, mesh)

    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# The pytest process: inputs, the ranks, the references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ba_problems():
    """``tests/test_ba.py::build_problem``'s problems of keys 0 and 3 (the
    latter with 40 gross outliers), as numpy fields and the JAX problem."""
    import jax

    from tests.test_ba import CX, CY, FX, FY, build_problem

    out = {}
    for name, key, n_out in (("key0", 0, 0), ("key3_outliers", 3, 40)):
        prob, R_true, t_true, _, n_obs = build_problem(jax.random.PRNGKey(key), n_outliers=n_out)
        out[name] = (prob, tuple(np.asarray(f) for f in prob), (FX, FY, CX, CY), n_obs,
                     np.asarray(R_true), np.asarray(t_true))
    return out


def _inputs():
    """Every case's inputs (numpy and the port's pickled store) and the JAX
    objects the references need."""
    import jax
    import jax.numpy as jnp

    from tests.synthetic import make_landmarks, make_trajectory
    from tests.test_matching_stack import make_bank
    from ur_mvo_tpu.models import superglue as JG
    from ur_mvo_tpu_torch.weights import map_store_from

    ba = _ba_problems()
    params = JG.init_params(jax.random.PRNGKey(0), num_layers=1)
    B, cap = 8, 32  # tests/test_parallel.py's matcher
    jb0 = [make_bank(jax.random.PRNGKey(10 + i), 20, cap) for i in range(B)]
    jb1 = [make_bank(jax.random.PRNGKey(50 + i), 24, cap) for i in range(B)]

    def stack(banks):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *banks)

    T_wc, ts = make_trajectory(ORACLE_FRAMES, advance=0.05)
    gts = []
    for s in range(ORACLE_S):
        off = np.eye(4)
        off[:3, 3] = [0, 0, 0.1 * s]
        gts.append(np.einsum("ij,njk->nik", off, T_wc))
    jstore, order = make_drifted_map()
    bcfg = dict(ba_iterations_phase1=4, ba_iterations_phase2=2)
    sp = SuperPoint().init_random(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    dp_batch = train_sp.make_batch(g, torch.rand((4, 64, 80), generator=g), translation=0.3)
    inp = {
        "ba": {k: (v[1], v[2]) for k, v in ba.items()},
        "sg": jax.tree.map(np.asarray, params),
        "banks0": tuple(np.asarray(f) for f in stack(jb0)), "banks1": tuple(np.asarray(f) for f in stack(jb1)),
        "X": [np.asarray(make_landmarks(400, along=2.0, seed=10 + s)) for s in range(ORACLE_S)],
        "gts": gts, "ts": np.asarray(ts),
        "store": pickle.dumps(map_store_from(jstore)), "cam": CAM, "bcfg": bcfg,
        "sp": {k: v.numpy() for k, v in sp.state_dict().items()},
        "dp_batch": {k: v.numpy() for k, v in dp_batch.items()},
    }
    return inp, {"ba": ba, "params": params, "banks": (stack(jb0), stack(jb1)), "order": order}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Both ranks' results and the references: ``(ranks, refs)``."""
    d = str(tmp_path_factory.mktemp("mesh"))
    inp, jx = _inputs()
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    roles = [str(r) for r in range(WORLD)] + ["port"]
    logs = [open(os.path.join(d, f"{role}.log"), "w") for role in roles]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_parallel", d, role, str(WORLD)],
                              cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT) for role, log in zip(roles, logs)]
    try:
        jax_refs = _jax_references(jx)
        deadline = time.monotonic() + RANK_DEADLINE_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for role, p in zip(roles, procs):
        with open(os.path.join(d, f"{role}.log")) as f:
            log = f.read()
        assert p.returncode == 0, f"process {role} exited {p.returncode}:\n{log[-4000:]}"
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    with open(os.path.join(d, "port_refs.pkl"), "rb") as f:
        port = pickle.load(f)
    return ranks, {"jax": jax_refs, "port": port, "order": jx["order"], "inputs": inp}


def _port_references(workdir):
    """The port's unsharded calls on the same inputs, in a process of their
    own beside the ranks (no JAX either), pickled to ``port_refs.pkl``."""
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    refs = {"ba": {}}
    for name, (fields, geom) in inp["ba"].items():
        res = bundle_adjust(ba_problem_from_numpy(fields), *geom)
        refs["ba"][name] = {"R": res.R_wc.numpy(), "t": res.t_wc.numpy(), "inliers": int(res.obs_inlier.sum())}
    sg = SuperGlue.from_state_dict(superglue_from_numpy(inp["sg"])).eval()
    b0, b1 = feature_bank_from_numpy(inp["banks0"]), feature_bank_from_numpy(inp["banks1"])
    with torch.no_grad():
        Z = sg.match_scores(b0, b1, 640, 512, 20, 4)
    refs["match"] = tuple(f.numpy() for f in stack_lanes(
        [decode_assignment(Z[i], b0.valid[i], b1.valid[i], 0.1) for i in range(Z.shape[0])]))
    refs["oracle"] = _oracle_run(inp, None)
    refs["neural"] = _neural_run(None)
    refs["global"] = _global_run(inp, None)
    refs["dp"] = _dp_step(inp, None)
    with open(os.path.join(workdir, "port_refs.pkl"), "wb") as f:
        pickle.dump(refs, f)


def _jax_references(jx):
    """The JAX package's ``dist_bundle_adjust`` and ``make_batched_matcher``
    on ``make_mesh(2)``."""
    from tests.test_ba import CX, CY, FX, FY
    from ur_mvo_tpu.parallel.dist_ba import dist_bundle_adjust as jax_dist_ba
    from ur_mvo_tpu.parallel.dist_ba import shard_problem as jax_shard
    from ur_mvo_tpu.parallel.dist_matching import make_batched_matcher as jax_matcher
    from ur_mvo_tpu.parallel.mesh import make_mesh as jax_make_mesh

    jmesh = jax_make_mesh(WORLD)
    refs = {"ba": {}}
    for name, (jprob, _, _, n_obs, R_true, t_true) in jx["ba"].items():
        jres = jax_dist_ba(jax_shard(jprob, WORLD), jmesh, FX, FY, CX, CY)
        refs["ba"][name] = {"R": np.asarray(jres.R_wc), "t": np.asarray(jres.t_wc),
                            "inliers": int(jres.obs_inlier.sum()), "n_obs": n_obs, "R_true": R_true,
                            "t_true": t_true}
    jm = jax_matcher(jx["params"], jmesh, 640, 512, sinkhorn_iterations=20, threshold=0.1)(*jx["banks"])
    refs["match"] = tuple(np.asarray(f) for f in jm)
    return refs


# ---------------------------------------------------------------------------
# Cases in the pytest process alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", [0, 3])
def test_shard_problem_equals_jax(key):
    """The permutation, the observation order and the padding equal the JAX
    function's, at 2 and 8 shards, on the problem as built (1,024
    observation rows) and cut to its valid rows rounded up to 8, where the
    heaviest of key 0's 8 shards overflows and the padding grows; the
    returned permutation restores every point."""
    from ur_mvo_tpu.parallel.dist_ba import shard_problem as jax_shard

    jfull, _, _, n_obs, _, _ = _ba_problems()["key0" if key == 0 else "key3_outliers"]
    O_cut = (n_obs + 7) // 8 * 8
    grew = []
    for jprob in (jfull, jfull._replace(**{f: getattr(jfull, f)[:O_cut]
                                           for f in ("obs_frame", "obs_point", "obs_uv", "obs_valid")})):
        prob = ba_problem_from_numpy(tuple(np.asarray(f) for f in jprob))
        for n in (2, 8):
            js = jax_shard(jprob, n)
            ts, perm = shard_problem(prob, n)
            for f in ("obs_frame", "obs_point", "obs_valid", "point_valid", "X", "obs_uv"):
                np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                              err_msg=f"{f}, n={n}, O={prob.obs_frame.shape[0]}")
            np.testing.assert_array_equal(ts.X.numpy()[np.argsort(perm)], prob.X.numpy())
            grew.append(ts.obs_frame.shape[0] > prob.obs_frame.shape[0])
    assert grew == [False, False, False, key == 0]


def test_c12_round_robin_inverse_scrambles_the_map():
    """ROADMAP C12: the JAX package's ``Backend._full_bundle_adjustment(mesh=)``
    writes points back through ``new_p = (old_p % nsh) * Pl + old_p // nsh``
    (``ur_mvo_tpu/runtime/backend.py:1213-1218``), the inverse of a
    round-robin partition, while its ``shard_problem`` partitions greedily
    by track length. On a problem with unequal track lengths that formula
    puts points in the wrong rows; the port's inverse, through the
    permutation its ``shard_problem`` returns, restores every one."""
    import jax

    from ur_mvo_tpu.parallel.dist_ba import shard_problem as jax_shard

    rng = np.random.default_rng(7)
    P_, F, O, nsh = 16, 8, 64, 2
    obs_p = rng.integers(0, P_, 48)
    fields = (np.tile(np.eye(3, dtype=np.float32), (F, 1, 1)), np.zeros((F, 3), np.float32), np.ones(F, bool),
              np.arange(F) < 2, rng.normal(size=(P_, 3)).astype(np.float32), np.ones(P_, bool),
              np.concatenate([rng.integers(0, F, 48), np.zeros(16, int)]).astype(np.int32),
              np.concatenate([obs_p, np.zeros(16, int)]).astype(np.int32),
              rng.normal(size=(O, 3)).astype(np.float32), np.arange(O) < 48)
    assert len(set(np.bincount(obs_p, minlength=P_))) > 1  # unequal track lengths
    from ur_mvo_tpu.ops.ba import BAProblem as JaxProblem

    js = jax_shard(JaxProblem(*(jax.numpy.asarray(f) for f in fields)), nsh)
    Pl = P_ // nsh
    old_p = np.arange(P_)
    X_jax = np.asarray(js.X)[(old_p % nsh) * Pl + old_p // nsh]
    wrong = int((X_jax != fields[4]).any(1).sum())
    assert wrong > 0, "the round-robin inverse restored every point"
    ts, perm = shard_problem(ba_problem_from_numpy(fields), nsh)
    X_port = torch.empty_like(ts.X).index_put_((torch.from_numpy(perm),), ts.X).numpy()
    np.testing.assert_array_equal(X_port, fields[4])


def test_backend_rule_and_no_quiet_fallback():
    """A CPU device cannot run NCCL; a CUDA device without CUDA raises (no
    move to the CPU); an unknown backend raises. None of these joins a
    world."""
    with pytest.raises(ValueError, match="NCCL"):
        tmesh.init_distributed("nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tmesh.init_distributed("mpi", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.init_distributed()
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.rank_device()
    assert not torch.distributed.is_initialized()


def test_a_world_joined_directly_never_runs_on_the_cpu(tmp_path):
    """A gloo world joined without ``init_distributed`` (as under torchrun),
    after a CPU world of ``init_distributed`` came and went: gloo does not
    mean the CPU, so ``make_mesh`` and ``MultiSequenceVO(mesh=)`` on a CPU
    ``DeviceMesh`` with no device take ``cuda:{LOCAL_RANK}`` and raise
    without CUDA."""
    with one_rank_mesh(tmp_path) as mesh:
        assert tmesh.mesh_rank_device(mesh) == torch.device("cpu")
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/direct", world_size=1, rank=0)
    try:
        cpu_mesh = torch.distributed.device_mesh.init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        assert tmesh.mesh_rank_device(cpu_mesh, "cpu") == torch.device("cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                tmesh.make_mesh()
            with pytest.raises(RuntimeError, match="CUDA"):
                MultiSequenceVO(_oracle_cfg(), make_pinhole(640, 512, 400.0, 400.0, 320.0, 256.0), 2, mesh=cpu_mesh)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# Cases of the world of two ranks
# ---------------------------------------------------------------------------

def test_collectives_keep_every_bit(world2):
    """``gather_batch`` sums the integer view: signed zeros and a NaN's
    payload come back as they were, on both ranks; bools as bools;
    ``replicate`` is rank 0's tensor."""
    ranks, _ = world2
    for r in ranks:
        np.testing.assert_array_equal(r["gather_bits"], BITS)
        np.testing.assert_array_equal(r["gather_flags"], [True, False, False, True])
        np.testing.assert_array_equal(r["replicate"], np.zeros(3, np.float32))


@pytest.mark.parametrize("name", ["key0", "key3_outliers"])
def test_dist_bundle_adjust_world2(world2, name):
    """``tests/test_parallel.py``'s tolerances. Key 0: R and t of the six
    real frames within 1e-3 of JAX's ``dist_bundle_adjust`` on
    ``make_mesh(2)`` and of the port's ``bundle_adjust``. The outlier
    problem (key 3, 40 gross outliers): within R 1e-2, t 5e-2 of the truth,
    35-45 observations rejected. Both: inlier counts equal to both
    references', both ranks equal."""
    ranks, refs = world2
    ref = refs["jax"]["ba"][name]
    for r in ranks:
        got = r["ba"][name]
        for other in (ref, refs["port"]["ba"][name]):
            if name == "key0":
                np.testing.assert_allclose(got["t"][:6], other["t"][:6], atol=1e-3)
                np.testing.assert_allclose(got["R"][:6], other["R"][:6], atol=1e-3)
            assert got["inliers"] == other["inliers"]
        for f in ("R", "t", "X"):
            np.testing.assert_array_equal(got[f], ranks[0]["ba"][name][f])
    if name == "key3_outliers":
        got = ranks[0]["ba"][name]
        assert np.abs(got["R"][:6] - ref["R_true"]).max() < 1e-2
        assert np.abs(got["t"][:6] - ref["t_true"]).max() < 5e-2
        assert ref["n_obs"] - 45 <= got["inliers"] <= ref["n_obs"] - 35


def test_dist_bundle_adjust_all_reduce_count_world2(world2):
    """``parallel.mesh.all_sum`` counts what ``dist_bundle_adjust`` sums, on
    both ranks and both problems: each LM step one ``all_reduce`` of the
    packed reduced camera system (``H_cc`` (FF, 6, 6), ``b_c`` (FF, 6),
    ``S_red`` (6FF, 6FF), ``b_red`` (6FF), float32) and one of the trial
    cost, each LM phase one more for its starting cost; at FF = 16 a step's
    bytes are the JAX source's 39,940 (``scripts/validate_ici_model.py``)
    in 2 calls where it makes 5. ``cli.bench_scaling.packed_terms`` works
    out the same."""
    from ur_mvo_tpu_torch.cli.bench_scaling import packed_terms

    ranks, _ = world2
    cfg = BAConfig()
    FF, steps = cfg.max_free_frames, cfg.iters_phase1 + cfg.iters_phase2
    step_bytes = 4 * (FF * 6 * 6 + FF * 6 + (6 * FF) * (6 * FF) + 6 * FF) + 4
    assert FF == 16 and step_bytes == 39940
    want = (2 * steps + 2, steps * step_bytes + 2 * 4)
    for r in ranks:
        for name in ("key0", "key3_outliers"):
            assert r["ba"][name]["all_sum"] == want, (r["rank"], name)
    terms = packed_terms(cfg)
    assert (terms["calls"], terms["bytes"], terms["bytes_a_step"], terms["calls_a_step"]) == (*want, step_bytes, 2)


def test_batched_matcher_world2(world2):
    """``tests/test_parallel.py``'s setup (one layer, B = 8, capacity 32):
    the gathered matches equal JAX's ``make_batched_matcher`` on
    ``make_mesh(2)`` (indices and verdicts on every slot, where
    ``tests/test_torch_multi_seq.py`` asks 99% of them; scores within 1e-5)
    and the port's unsharded batched match bit for bit, on both ranks."""
    ranks, refs = world2
    for r in ranks:
        idx, score, valid = r["match"]
        np.testing.assert_array_equal(idx, refs["jax"]["match"][0])
        np.testing.assert_array_equal(valid, refs["jax"]["match"][2])
        np.testing.assert_allclose(score, refs["jax"]["match"][1], atol=1e-5)
        for a, b in zip(r["match"], refs["port"]["match"]):
            np.testing.assert_array_equal(a, b)
    assert refs["jax"]["match"][2].sum() > 0


def test_multi_sequence_mesh_world2(world2):
    """``MultiSequenceVO(mesh)`` at S = 2 (a lane a rank) against the same
    object without a mesh: every frame's poses of both lanes, on both
    ranks, and the trajectories bit for bit (the oracle lanes: batched
    mutual-NN match, batched track, trackers, BA); the neural lanes' init
    banks at the batched-lane tolerance; S = 3 on two ranks raises."""
    ranks, refs = world2
    refs = refs["port"]
    ref_poses, ref_traj = refs["oracle"]
    assert sum(p is not None for frame in ref_poses for p in frame) >= 4
    for r in ranks:
        assert "do not split over a mesh of 2" in r["odd_S"]
        poses, traj = r["oracle"]
        for a, b in zip(poses, ref_poses):
            assert len(a) == ORACLE_S and [x is None for x in a] == [x is None for x in b]
            for x, y in zip(a, b):
                if x is not None:
                    np.testing.assert_array_equal(x, y)
        for (ts_a, R_a, t_a), (ts_b, R_b, t_b) in zip(traj, ref_traj):
            assert len(ts_a) == len(ts_b) >= 3
            np.testing.assert_array_equal(R_a, R_b)
            np.testing.assert_array_equal(t_a, t_b)
        npose, banks = r["neural"]
        assert [[x is None for x in f] for f in npose] == [[x is None for x in f] for f in refs["neural"][0]]
        (i, bank), = banks.items()
        assert i == r["rank"]
        ref = refs["neural"][1][i]
        vt = bank[3]
        assert vt.sum() == ref[3].sum() > 50
        same = (bank[1] == ref[1]).all(-1) & vt
        assert same.sum() / vt.sum() >= 0.99
        np.testing.assert_allclose(bank[0], ref[0], atol=1e-5)
        np.testing.assert_allclose(bank[2][same], ref[2][same], atol=1e-5)


def test_global_optimize_mesh_world2(world2):
    """``global_optimize(mesh)`` at world 2 on ``tests/test_torch_loop.py``'s
    drifted map, its full BA in float32 on both routes (``_global_run``),
    against ``global_optimize()``: keyframe poses and every used point
    within 1e-3. Both ranks write the same store; the full BA records its
    sharding."""
    ranks, refs = world2
    order, ref = refs["order"], refs["port"]["global"]
    store = pickle.loads(refs["inputs"]["store"])
    used = store.mp_good & ~store.mp_bad
    assert ref["full_ba"]["assembly"] == "scatter"
    for r in ranks:
        got = r["global"]
        full = got["full_ba"]
        assert full["assembly"] == "dist" and full["world"] == WORLD
        assert full["rank_assembly"] == ["scatter"] * WORLD
        assert full["points"] == ref["full_ba"]["points"]
        np.testing.assert_allclose(got["kf_R"][order], ref["kf_R"][order], atol=1e-3)
        np.testing.assert_allclose(got["kf_t"][order], ref["kf_t"][order], atol=1e-3)
        np.testing.assert_allclose(got["mp_pos"][used], ref["mp_pos"][used], atol=1e-3)
        assert not np.allclose(got["kf_t"][order], store.kf_t[order])
        for f in ("kf_R", "kf_t", "mp_pos"):
            np.testing.assert_array_equal(got[f], ranks[0]["global"][f])


def test_dp_train_step_world2(world2):
    """``make_dp_train_step`` at world 2, each rank on half of a 4-image
    batch, against the single-process step on the whole batch: the loss
    (the whole batch's: each rank divides by the whole batch's valid-cell
    count) within rtol 1e-5, the summed gradients within 1e-5 of the
    largest, the parameters after one Adam step within 1e-6 where the
    gradient is not within 100x of Adam's epsilon (there, lr); both
    replicas bit for bit equal. The halves' valid-cell counts differ, so a
    mean of the ranks' own losses would miss."""
    ranks, refs = world2
    ref = refs["port"]["dp"]
    mask = refs["inputs"]["dp_batch"]["mask"]
    assert mask[:2].sum() != mask[2:].sum()
    scale = max(np.abs(g).max() for g in ref["grads"].values())
    for r in ranks:
        got = r["dp"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert set(got["params"]) == set(ref["params"]) == {"convDa.weight", "convDa.bias", "convDb.weight",
                                                             "convDb.bias"}
        for k, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][k] / scale, g / scale, atol=1e-5, err_msg=k)
            limit = np.where(np.abs(g) > 1e-6, 1e-6, 1e-3)
            assert np.all(np.abs(got["params"][k] - ref["params"][k]) <= limit), k
            np.testing.assert_array_equal(got["params"][k], ranks[0]["dp"]["params"][k])


if __name__ == "__main__":
    if sys.argv[2] == "port":
        _port_references(sys.argv[1])
    else:
        _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
