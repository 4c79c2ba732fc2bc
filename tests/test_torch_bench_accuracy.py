"""The port's accuracy matrix (``ur_mvo_tpu_torch.cli.bench_accuracy``)
against ``scripts/bench_accuracy.py`` on the CPU: the production
configuration field for field (and ``chip_smoke.py``'s, which now reads
it), the scene families' renders, the whole protocol (rows, merge,
protocol blocks) with one stand-in engine in place of ``UR_MVO`` in both
packages, and one real run of the port's CLI with the deterministic
setting it takes on CUDA given back to the caller.

The JAX script imports no JAX at module level; it is loaded fresh for each
call of its ``main``, which rewrites its module globals under ``--long``.
"""

import dataclasses
import enum
import hashlib
import importlib.util
import json
import os
import sys
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from ur_mvo_tpu_torch.cli import bench_accuracy as tba
from ur_mvo_tpu_torch.device import deterministic_on

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACCURACY_JSON = os.path.join(REPO, "ACCURACY.json")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script():
    """A fresh module of ``scripts/bench_accuracy.py``."""
    spec = importlib.util.spec_from_file_location("jax_bench_accuracy", os.path.join(REPO, "scripts", "bench_accuracy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(cfg):
    """``dataclasses.asdict`` with enums as their values (each package has
    its own ``SensorSetup``)."""

    def plain(v):
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v.value if isinstance(v, enum.Enum) else v

    return plain(dataclasses.asdict(cfg))


@pytest.mark.parametrize("long_run", [False, True])
@pytest.mark.parametrize("matcher", ["nn", "sg", "hybrid"])
def test_production_cfg_equals_jax(matcher, long_run):
    """Field for field the JAX ``_production_cfg``, at the short and the long
    protocols' sizes, with the production defaults and with ``margin`` and
    ``nn_floor`` overridden."""
    jax_script = _jax_script()
    w, h = (tba.LONG_W, tba.LONG_H) if long_run else (tba.W, tba.H)
    for margin, nn_floor in ((None, None), (0.3, 25)):
        ours = tba.production_cfg(matcher, None, margin, nn_floor, W=w, H=h, long_run=long_run)
        ref = jax_script._production_cfg(matcher, None, margin, nn_floor, W=w, H=h, long_run=long_run)
        assert _fields(ours) == _fields(ref)
    assert (tba.H, tba.W, tba.FX, tba.BASELINE_M, tba.FPS) == (jax_script.H, jax_script.W, jax_script.FX,
                                                               jax_script.BASELINE_M, jax_script.FPS)
    assert tba.SCENES == jax_script.SCENES and tba.SETUP_SCENES == jax_script.SETUP_SCENES


def test_chip_smoke_configs_are_the_production_cfg():
    """The gated card phases' configurations (``chip_smoke.production_config``
    for mono/3d and mono/long, ``metric_config`` for the stereo and RGB-D
    protocols), which ``chip_smoke.py`` reads from the CLI, field for field
    the JAX script's for the same four (matcher, size) pairs. No engine is
    built."""
    sys.path.insert(0, REPO)
    import chip_smoke

    jax_script = _jax_script()
    short, long_ = dict(W=tba.W, H=tba.H), dict(W=tba.LONG_W, H=tba.LONG_H, long_run=True)
    pairs = [
        (chip_smoke.production_config(), jax_script._production_cfg("sg", **short)),
        (chip_smoke.production_config(long_run=True), jax_script._production_cfg("sg", **long_)),
        (chip_smoke.metric_config("stereo/3d"), jax_script._production_cfg("hybrid", **short)),
        (chip_smoke.metric_config("rgbd/3d"), jax_script._production_cfg("hybrid", **short)),
        (chip_smoke.metric_config("rgbd/long"), jax_script._production_cfg("hybrid", **long_)),
    ]
    for ours, ref in pairs:
        assert _fields(ours) == _fields(ref)


@pytest.mark.parametrize("scene", sorted(tba.SCENES))
def test_scenes_render_as_jax(scene):
    """Each scene family (stereo baseline 0.12, 4 frames, seed 11): on the
    JAX package's camera poses the port's images, depths, right images and
    poses are its arrays byte for byte. On its own default trajectory (a
    numpy Rodrigues where the JAX package's is float32) the poses agree to
    1e-6, which moves fewer than 1e-3 of the pixels by one grey level and
    the depths by float32 rounding."""
    from ur_mvo_tpu.utils.synthscene import render_sequence as jax_render

    kw = dict(seed=11, baseline=tba.BASELINE_M, **tba.SCENES[scene])
    ref = jax_render(4, tba.H, tba.W, tba.FX, **kw)
    same_poses = tba_render(4, poses=ref[1], **kw)
    own = tba_render(4, **kw)
    assert len(ref) == len(same_poses) == len(own) == 4
    for a, b in zip(same_poses, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(own[1], ref[1], rtol=0, atol=1e-6)
    for i in (0, 3):
        diff = np.abs(own[i].astype(np.int16) - ref[i].astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(own[2], ref[2], rtol=1e-6)


def tba_render(n, poses=None, **kw):
    from ur_mvo_tpu_torch.utils.synthscene import render_sequence

    return render_sequence(n, tba.H, tba.W, tba.FX, poses=poses, **kw)


# ---------------------------------------------------------------------------
# The whole protocol with a stand-in engine
# ---------------------------------------------------------------------------

def _digest(image):
    return hashlib.sha1(np.ascontiguousarray(image).tobytes()).hexdigest()


class StandIn:
    """In place of ``UR_MVO`` in both packages. It knows each scene's truth
    by its first image (``truths``: digest -> (T_wc, seed), filed as the
    benchmark renders the scene), and on every
    second frame emits the poses of the frames since its last emission at
    the truth plus noise drawn from the scene's seed, each emission a
    keyframe. An engine with SuperGlue weights fails seed 12: it emits
    once (two poses). ``global_optimize`` halves the keyframes' noise."""

    truths: dict = {}

    def __init__(self, cfg, setup, camera=None, device=None):
        self.learned = cfg.superglue.weights_path is not None
        store = SimpleNamespace(num_keyframes=lambda: len(self.kf))
        self.tracker = SimpleNamespace(initialized=False, frames_lost=0, relocalizations=0,
                                       backend=SimpleNamespace(global_optimize=self._global_optimize, store=store))
        self.reset()

    def reset(self):
        self.i, self.kf, self.noise_scale = 0, [], 1.0
        self.tracker.initialized = False

    def process(self, frame, next_data=None):
        i, self.i = self.i, self.i + 1
        if i == 0:
            self.T_wc, self.seed = self.truths[_digest(frame.image.get_image())]
            self.rng = np.random.default_rng(self.seed)
        self.tracker.initialized = i >= 1
        if i % 2 == 0 or (self.learned and self.seed == 12 and i > 1):
            return []
        poses = [SimpleNamespace(translation=self.T_wc[k, :3, 3] + self.rng.normal(0.0, 0.05, 3))
                 for k in (i - 1, i)]
        self.kf.append((i / tba.FPS, self.T_wc[i, :3, 3], self.rng.normal(0.0, 0.05, 3)))
        return poses

    def _global_optimize(self):
        self.noise_scale = 0.5

    def keyframe_trajectory(self):
        ts = [t for t, _, _ in self.kf]
        pos = np.stack([p + self.noise_scale * n for _, p, n in self.kf])
        return ts, pos, None

    def shutdown(self):
        pass


SHORT_ARGS = ["--cells", "mono/plane,stereo/decay,rgbd/3d", "--matchers", "nn,sg", "--seeds", "2", "--frames", "6"]
LONG_ARGS = ["--long", "--cells", "mono/long", "--seeds", "2", "--frames", "6"]


def _recording(render):
    """``render`` that files each scene's truth under its first image's
    digest for the stand-in, as the benchmark renders it."""

    def wrapped(*args, seed, **kw):
        out = render(*args, seed=seed, **kw)
        StandIn.truths[_digest(out[0][0])] = (out[1], seed)
        return out

    return wrapped


def test_protocol_rows_equal_jax_on_a_stand_in_engine(tmp_path):
    """The JAX script's ``main`` and the port's, each with the stand-in in
    place of its package's ``UR_MVO``: over three short cells and two
    matchers, then the long protocol merged into the same file, the written
    ``cells`` are equal (failed runs scored at the penalty, ``pgo_mean``
    over the runs that did not fail: C5), and so are the ``protocol`` and
    ``protocol_long`` blocks; the second run keeps the first run's cells."""
    from ur_mvo_tpu.utils import synthscene as jax_scene
    from ur_mvo_tpu_torch.utils import synthscene

    jax_out, our_out = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    docs = []
    for extra in (SHORT_ARGS, LONG_ARGS):
        with mock.patch("ur_mvo_tpu.engine.UR_MVO", StandIn), \
                mock.patch.object(jax_scene, "render_sequence", _recording(jax_scene.render_sequence)), \
                mock.patch.object(sys, "argv", ["bench_accuracy.py", *extra, "--out", jax_out]):
            _jax_script().main()
        with mock.patch("ur_mvo_tpu_torch.engine.UR_MVO", StandIn), \
                mock.patch.object(synthscene, "render_sequence", _recording(synthscene.render_sequence)):
            ours = tba.main([*extra, "--device", "cpu", "--out", our_out])
        with open(jax_out) as f:
            ref = json.load(f)
        with open(our_out) as f:
            got = json.load(f)
        assert got["cells"] == ref["cells"]
        for block in ("protocol", "protocol_long"):
            assert got.get(block) == ref.get(block)
        assert ours["doc"] == got
        docs.append(got)

    short, merged = docs
    assert sorted(short["cells"]) == ["mono/plane", "rgbd/3d", "stereo/decay"]
    assert sorted(merged["cells"]) == ["mono/long", "mono/plane", "rgbd/3d", "stereo/decay"]
    for cell in short["cells"]:
        assert merged["cells"][cell] == short["cells"][cell]
        assert short["cells"][cell]["sg"]["failed"] == 1 and short["cells"][cell]["nn"]["failed"] == 0
    long_sg = merged["cells"]["mono/long"]["sg"]
    assert long_sg["failed"] == 1 and long_sg["runs"][1] is None
    assert len(long_sg["pgo_runs"]) == 1 and long_sg["pgo_mean"] == long_sg["pgo_runs"][0]
    assert len(merged["cells"]["mono/long"]["nn"]["pgo_runs"]) == 2
    # a run per seed, cell and matcher, read from the engine
    assert [(r["cell"], r["matcher"], r["seed"]) for r in ours["runs"]] == [
        ("mono/long", m, s) for m in ("nn", "sg") for s in (11, 12)]
    assert [r["poses_emitted"] for r in ours["runs"]] == [6, 6, 6, 2]


# ---------------------------------------------------------------------------
# The CLI itself on the CPU
# ---------------------------------------------------------------------------

def test_cli_runs_a_cell_on_the_cpu(tmp_path):
    """``--device cpu --cells mono/plane --matchers nn --seeds 1``: one row
    with a finite ATE (16 frames: at 8 the NN matcher emits one pose on this
    scene, a failed run), written to ``--out``; ``ACCURACY.json`` untouched;
    the caller's deterministic setting as it was; without CUDA ``--device
    cuda`` (the default) raises before any work."""
    def digest():
        with open(ACCURACY_JSON, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = digest()
    was = torch.are_deterministic_algorithms_enabled()
    out = str(tmp_path / "acc.json")
    res = tba.main(["--device", "cpu", "--cells", "mono/plane", "--matchers", "nn", "--seeds", "1", "--frames", "16",
                    "--out", out])
    assert torch.are_deterministic_algorithms_enabled() == was
    with open(out) as f:
        doc = json.load(f)
    row = doc["cells"]["mono/plane"]["nn"]
    assert list(doc["cells"]) == ["mono/plane"] and row["failed"] == 0
    assert np.isfinite(row["mean"]) and row["runs"] == [row["mean"]] and 0 < row["mean"] < 0.5
    (run,) = res["runs"]
    assert run["initialised_at_frame"] is not None and run["keyframes"] >= 3 and run["poses_emitted"] >= 5
    assert res["cells"][0]["launches"] == {}  # the CPU runs the plain versions
    assert digest() == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tba.main(["--cells", "mono/plane", "--out", str(tmp_path / "never.json")])
        assert not os.path.exists(tmp_path / "never.json")


def test_merge_rows_keeps_other_cells_and_matchers(tmp_path):
    """``merge_rows`` merges as the JAX script does: a later run updates
    only its own cells and matchers and its own protocol block, keeps the
    rest, and an unreadable file starts afresh."""
    path = str(tmp_path / "acc.json")
    tba.merge_rows(path, {"mono/plane": {"nn": {"mean": 1.0}}}, "protocol", {"frames": 24})
    tba.merge_rows(path, {"mono/plane": {"sg": {"mean": 2.0}}, "mono/long": {"sg": {"mean": 3.0}}},
                   "protocol_long", {"frames": 120})
    with open(path) as f:
        doc = json.load(f)
    assert doc["cells"] == {"mono/plane": {"nn": {"mean": 1.0}, "sg": {"mean": 2.0}},
                            "mono/long": {"sg": {"mean": 3.0}}}
    assert doc["protocol"] == {"frames": 24} and doc["protocol_long"] == {"frames": 120}
    with open(path, "w") as f:
        f.write("{not json")
    assert tba.merge_rows(path, {"rgbd/3d": {"nn": {"mean": 4.0}}}, "protocol", {})["cells"] == {
        "rgbd/3d": {"nn": {"mean": 4.0}}}


def test_deterministic_on_restores_the_callers_setting():
    """On a CUDA device the CLIs' context turns on deterministic algorithms
    with ``warn_only`` and gives back whatever the caller had, also after an
    exception; on the CPU it touches nothing."""
    was = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        for prior in ((False, False), (True, False), (True, True)):
            torch.use_deterministic_algorithms(prior[0], warn_only=prior[1])
            with deterministic_on(torch.device("cuda")):
                assert torch.are_deterministic_algorithms_enabled()
                assert torch.is_deterministic_algorithms_warn_only_enabled()
            assert (torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled()) == prior
            with pytest.raises(ValueError), deterministic_on(torch.device("cuda")):
                raise ValueError("a failed run")
            assert (torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled()) == prior
            with deterministic_on(torch.device("cpu")):
                assert (torch.are_deterministic_algorithms_enabled(),
                        torch.is_deterministic_algorithms_warn_only_enabled()) == prior
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
