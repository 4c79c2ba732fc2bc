"""The port's I/O and command-line entry points on the CPU, against the JAX
package: ``dataset`` (EuRoC and flat layouts, PNG / PGM / uint8 ``.npy``,
``cam1`` / ``depth0`` / ``mask0``, colmap ``images.txt``), the native
runtime (prefetcher, queue, TUM writer), ``cli.make_synthetic_dataset``
against ``scripts/make_synthetic_dataset.py``, and ``cli.run_vo`` /
``cli.run_vo_multi`` in-process on datasets the port writes.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ur_mvo_tpu import dataset as jdataset
from ur_mvo_tpu import native as jnative
from ur_mvo_tpu_torch import dataset as tdataset
from ur_mvo_tpu_torch import native as tnative
from ur_mvo_tpu_torch.cli import make_synthetic_dataset, run_vo, run_vo_multi
from ur_mvo_tpu_torch.utils.tum_io import read_tum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TS0 = 1_400_000_000_000_000_000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_pgm(path, img):
    with open(path, "wb") as f:
        f.write(b"P5\n# test\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def _save(path, img, fmt):
    if fmt == "png":
        from PIL import Image

        Image.fromarray(img).save(path + ".png")
    elif fmt == "pgm":
        _write_pgm(path + ".pgm", img)
    else:
        np.save(path + ".npy", img)


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

# name: (layout, format of the left frames, sides, reader the port takes)
DATASETS = {
    "euroc_npy": ("euroc", "npy", True, "native"),
    "euroc_png": ("euroc", "png", True, "python"),
    "flat_pgm": ("flat", "pgm", False, "native"),
    "flat_mixed": ("flat", "mixed", False, "python"),
}


def _make_tree(root, layout, fmt, sides):
    rng = np.random.default_rng(7)
    left = root / "cam0" / "data" if layout == "euroc" else root
    dirs = {"left": left}
    if sides:
        dirs.update(right=root / "cam1" / "data", depth=root / "depth0" / "data", mask=root / "mask0" / "data")
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    for i in range(5):
        stem = str(TS0 + i * 33_333_333) if layout == "euroc" else f"{i:06d}"
        f = fmt if fmt != "mixed" else ("png", "pgm", "npy")[i % 3]
        _save(str(dirs["left"] / stem), rng.integers(0, 256, (12, 16), dtype=np.uint8), f)
        if sides:
            _save(str(dirs["right"] / stem), rng.integers(0, 256, (12, 16), dtype=np.uint8), f)
            np.save(str(dirs["depth"] / (stem + ".npy")), rng.uniform(0.5, 9.0, (12, 16)).astype(np.float32))
            _save(str(dirs["mask"] / stem), (rng.random((12, 16)) > 0.3).astype(np.uint8) * 255, f)


@pytest.mark.parametrize("name", list(DATASETS))
def test_dataset_reads_what_the_jax_package_reads(name, tmp_path):
    layout, fmt, sides, reader = DATASETS[name]
    _make_tree(tmp_path, layout, fmt, sides)
    kw = dict(use_right=sides, use_depth=sides, use_mask=sides)
    port, ref = tdataset.Dataset(str(tmp_path), **kw), jdataset.Dataset(str(tmp_path), **kw)
    assert port.reader == reader
    assert len(port) == len(ref) == 5 and port.names == ref.names
    for a, b in zip(port, ref):
        assert (a.index, a.time) == (b.index, b.time)
        for field in ("image", "image_right", "depth", "mask"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None) == (field != "image" and not sides), field
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), field


def test_colmap_images_txt_matches_jax(tmp_path):
    """Camera centres and world-from-camera quaternions of colmap poses,
    POINTS2D lines skipped, order by timestamp: 1e-6 of the JAX package's."""
    rng = np.random.default_rng(3)
    lines = ["# Image list", "# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME"]
    for k, i in enumerate((3, 1, 2, 0)):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        lines.append(f"{k + 1} {' '.join(f'{v:.9f}' for v in q)} {' '.join(f'{v:.9f}' for v in t)} 1 {TS0 + i * 1000}.png")
        lines.append("12.5 3.5 -1 40.0 7.0 2")
    path = tmp_path / "images.txt"
    path.write_text("\n".join(lines) + "\n")
    got, ref = tdataset.load_colmap_images_txt(str(path)), jdataset.load_colmap_images_txt(str(path))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-6)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-6)


# ---------------------------------------------------------------------------
# the native runtime
# ---------------------------------------------------------------------------

def test_native_runtime_matches_jax(tmp_path):
    """The prefetcher's images, the queue's order and the writer's bytes,
    the same as the JAX package's native runtime on the same inputs; the
    library is built beside the package, not in it."""
    rng = np.random.default_rng(1)
    paths = []
    for i in range(10):
        img = rng.integers(0, 256, (9 + i, 13), dtype=np.uint8)
        p = str(tmp_path / f"{i:03d}")
        _save(p, img, "pgm" if i % 2 else "npy")
        paths.append(p + (".pgm" if i % 2 else ".npy"))
    port, ref = tnative.ImagePrefetcher(paths, n_workers=3, window=4), jnative.ImagePrefetcher(paths, n_workers=2, window=3)
    for i in range(10):  # in order: a prefetcher serves each frame once
        a, b = port.get(i), ref.get(i)
        assert a.dtype == np.uint8 and np.array_equal(a, b) and np.array_equal(a, tdataset.load_gray(paths[i]))
    port.close()
    ref.close()

    items = [rng.integers(0, 256, n, dtype=np.uint8) for n in (5, 0, 17, 3)]
    popped = []
    for q in (tnative.BoundedQueue(capacity=8), jnative.BoundedQueue(capacity=8)):
        for it in items:
            q.push(it)
        assert len(q) == len(items)
        popped.append([q.pop() for _ in items])
        q.close()
        assert q.pop() is None
        q.destroy()
    for a, b, it in zip(popped[0], popped[1], items):
        assert np.array_equal(a, b) and np.array_equal(a, it)

    files = []
    for mod, name in ((tnative, "port.txt"), (jnative, "jax.txt")):
        w = mod.NativeTumWriter(str(tmp_path / name))
        for k in range(4):
            w.write(1.5 + k / 30.0, np.array([k, -0.25 * k, 1e-3]), np.array([0.5, 0.5, -0.5, 0.5]))
        w.close()
        files.append((tmp_path / name).read_bytes())
    assert files[0] == files[1] and files[0].count(b"\n") == 4
    assert tnative.LIBRARY.parent == Path(REPO) / "build" / "ur_mvo_tpu_torch_native"
    assert tnative.LIBRARY.exists()
    assert not [n for n in os.listdir(os.path.dirname(tnative.__file__)) if n.endswith(".so")]


def test_dataset_reads_out_of_order_frames_from_their_files(tmp_path):
    """The prefetcher serves each frame once, in order, within a window of
    16: a frame read out of order or again comes from its file instead of
    waiting on the prefetcher for ever."""
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (6, 8), dtype=np.uint8) for _ in range(24)]
    for i, img in enumerate(imgs):
        np.save(str(tmp_path / f"{i:04d}.npy"), img)
    ds = tdataset.Dataset(str(tmp_path))
    assert ds.reader == "native"
    for i in (23, 0, 0, 1, 22, 2):
        assert np.array_equal(ds.get(i).image, imgs[i])
    assert all(np.array_equal(d.image, imgs[i]) for i, d in enumerate(ds))


def test_native_needs_only_a_compiler_and_never_hides_a_failed_build(monkeypatch, tmp_path):
    """Without ``g++`` (and nothing loaded) the runtime is unavailable and
    ``Dataset`` reads with Python; with a compiler, a source that does not
    build raises instead of falling back."""
    _make_tree(tmp_path / "seq", "flat", "npy", False)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert not tnative.available()
    ds = tdataset.Dataset(str(tmp_path / "seq"))
    assert ds.reader == "python" and len(list(ds)) == 5
    monkeypatch.undo()
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "SOURCE", broken)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "LIBRARY", tmp_path / "build" / "liburmvo_io.so")
    with pytest.raises(RuntimeError, match="failed"):
        tnative.load_library()


# ---------------------------------------------------------------------------
# make_synthetic_dataset against the JAX package's script
# ---------------------------------------------------------------------------

def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_make_synthetic_dataset",
                                                  os.path.join(REPO, "scripts", "make_synthetic_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("args", [
    ["--frames", "5", "--size", "48", "64", "--seed", "3"],
    ["--frames", "4", "--size", "48", "64", "--seed", "2", "--scene", "3d", "--setup", "stereo", "--masks"],
    ["--frames", "4", "--size", "48", "64", "--seed", "2", "--setup", "rgbd"],
], ids=["plane_mono", "3d_stereo_masks", "plane_rgbd"])
def test_make_synthetic_dataset_writes_the_jax_scripts_tree(args, tmp_path, monkeypatch):
    """Both run in-process on the same flags: the same files, images within
    one grey level, depth and calibration equal, ground truth within 1e-6;
    the plane renderer's poses within 1e-6 of the JAX script's."""
    make_synthetic_dataset.main(["--out", str(tmp_path / "port")] + args)
    monkeypatch.setattr(sys, "argv", ["make_synthetic_dataset.py", "--out", str(tmp_path / "jax")] + args)
    script = _jax_script()
    script.main()
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert _tree(port) == _tree(ref)
    for rel in _tree(port):
        if rel.endswith(".png"):
            a, b = tdataset.load_gray(str(port / rel)).astype(int), tdataset.load_gray(str(ref / rel)).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel
        elif rel.endswith(".npy"):
            np.testing.assert_allclose(np.load(port / rel), np.load(ref / rel), atol=1e-5, err_msg=rel)
        elif rel == "camera.yaml":
            assert (port / rel).read_text() == (ref / rel).read_text()
    (ta, pa, qa), (tb, pb, qb) = read_tum(str(port / "gt.txt")), read_tum(str(ref / "gt.txt"))
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_allclose(pa, pb, atol=1e-6)
    np.testing.assert_allclose(qa, qb, atol=1e-6)
    if "3d" not in args:
        n = int(args[1])
        T_port = make_synthetic_dataset.render_plane_sequence(n, 48, 64, 260.0, int(args[6]))[1]
        T_ref = script.render_plane_sequence(n, 48, 64, 260.0, int(args[6]))[1]
        np.testing.assert_allclose(T_port, T_ref, atol=1e-6)


def test_make_synthetic_dataset_writes_npy_frames_for_the_native_reader(tmp_path):
    make_synthetic_dataset.main(["--out", str(tmp_path / "seq"), "--frames", "3", "--size", "48", "64",
                                 "--image-format", "npy", "--setup", "stereo", "--masks"])
    ds = tdataset.Dataset(str(tmp_path / "seq"), use_right=True, use_mask=True)
    assert ds.reader == "native" and ds.names[0].endswith(".npy")
    png_free = [n for n in _tree(tmp_path / "seq") if n.endswith(".png")]
    assert not png_free
    frames = list(ds)
    assert len(frames) == 3 and frames[0].image.dtype == np.uint8 and frames[0].image.shape == (48, 64)
    assert frames[0].image_right.shape == (48, 64) and frames[0].mask.shape == (48, 64)


# ---------------------------------------------------------------------------
# run_vo and run_vo_multi, in-process
# ---------------------------------------------------------------------------

def _config(tmp_path):
    """The shipped detector with mutual-NN matching and a 512-slot bank: an
    RGB-D sequence at 120x160 initialises on its first frame."""
    path = tmp_path / "cfg.yaml"
    path.write_text(
        "superpoint: {weights_path: %s, keypoint_threshold: 1.0e-4, capacity: 512, max_keypoints: 512}\n"
        "superglue: {matcher: nn}\n"
        "initializer: {min_matches: 60, min_features_first: 100}\n"
        "keyframe: {max_num_passed_frame: 3}\n" % os.path.join(REPO, "weights", "superpoint_scratch_v3.npz"))
    return str(path)


def _json_line(out):
    return json.loads(out.strip().splitlines()[-1])


def _run_vo(root, seq, cfg, out, *extra):
    """``run_vo.main`` over the RGB-D sequence; its last stdout line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_vo.main(["--images", str(seq), "--setup", "rgbd", "--gt", str(seq / "gt.txt"), "--device", "cpu",
                     "--results", str(root / out), "--stride", "1", "--config", cfg, *extra])
    return _json_line(buf.getvalue())


@pytest.fixture(scope="module")
def rgbd_run(tmp_path_factory):
    """An 8-frame 120x160 RGB-D ``3d`` sequence with ``.npy`` frames, and
    ``run_vo`` over it frame by frame."""
    root = tmp_path_factory.mktemp("run_vo")
    seq = root / "seq"
    make_synthetic_dataset.main(["--out", str(seq), "--frames", "8", "--size", "120", "160", "--scene", "3d",
                                 "--setup", "rgbd", "--image-format", "npy"])
    cfg = _config(root)
    return root, seq, cfg, _run_vo(root, seq, cfg, "per_frame")


def test_run_vo_writes_poses_keyframes_and_the_ate_line(rgbd_run):
    root, _, _, rec = rgbd_run
    assert set(rec) == {"ate_rmse_m", "fps", "n_poses", "n_gt_matched"}
    ts, pos, quat = read_tum(str(root / "per_frame" / "poses.txt"))
    assert rec["n_poses"] == len(ts) >= 6 and rec["n_gt_matched"] == len(ts)
    assert np.isfinite(pos).all() and np.allclose(np.linalg.norm(quat, axis=1), 1.0, atol=1e-5)
    kts, _, _ = read_tum(str(root / "per_frame" / "keyframes.txt"))
    assert len(kts) >= 2 and set(kts) <= set(ts)
    assert 0.0 <= rec["ate_rmse_m"] < 0.05


def test_run_vo_chunked_writes_the_per_frame_run(rgbd_run):
    """``--chunk 3`` on the same directory: the same poses, keyframes and
    ATE (a consumed chunk row is the per-frame frame bit for bit)."""
    root, seq, cfg, rec = rgbd_run
    chunked = _run_vo(root, seq, cfg, "chunked", "--chunk", "3")
    for name in ("poses.txt", "keyframes.txt"):
        assert (root / "chunked" / name).read_bytes() == (root / "per_frame" / name).read_bytes(), name
    assert (chunked["ate_rmse_m"], chunked["n_poses"]) == (rec["ate_rmse_m"], rec["n_poses"])


def test_run_vo_multi_on_two_sequences(tmp_path, capsys):
    seqs = []
    for seed in (1, 2):
        seq = tmp_path / f"seq{seed}"
        make_synthetic_dataset.main(["--out", str(seq), "--frames", "8", "--size", "120", "160", "--scene", "3d",
                                     "--seed", str(seed), "--image-format", "npy"])
        seqs.append(seq)
    capsys.readouterr()
    run_vo_multi.main(["--images", *map(str, seqs), "--gt", *(str(s / "gt.txt") for s in seqs),
                       "--results", str(tmp_path / "out"), "--config", _config(tmp_path), "--device", "cpu"])
    recs = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["seq"] for r in recs] == ["seq1", "seq2"]
    for i, r in enumerate(recs):
        ts, pos, _ = read_tum(str(tmp_path / "out" / f"keyframes_{i}_seq{i + 1}.txt"))
        assert r["n_keyframes"] == len(ts) >= 3 and np.isfinite(pos).all()
        assert 0.0 <= r["ate_rmse_m"] < 0.35


def test_entry_points_need_cuda_unless_asked_for_the_cpu(tmp_path):
    """With no ``--device`` (or ``--device cuda``) and no CUDA the CLIs
    raise: the port never moves quietly to the CPU."""
    if torch.cuda.is_available():
        return  # the entry points take the card
    make_synthetic_dataset.main(["--out", str(tmp_path / "seq"), "--frames", "2", "--size", "48", "64"])
    seq = str(tmp_path / "seq")
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_vo.main(["--images", seq, "--results", str(tmp_path / "out")] + extra)
        with pytest.raises(RuntimeError, match="CUDA"):
            run_vo_multi.main(["--images", seq, "--results", str(tmp_path / "out")] + extra)
