"""The extractor's options in the port against the JAX package on the CPU:
sub-pixel peaks (``superpoint.subpixel``), patch descriptors
(``descriptor_source="patch"``) and resolution buckets; and a check that
with every option at its default the extractor and the tracker's frame
step give the bits they gave before these options were ported."""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ur_mvo_tpu import config as jconfig
from ur_mvo_tpu.camera import make_pinhole as jax_pinhole
from ur_mvo_tpu.ops.gridsample import patch_descriptors as jax_patch
from ur_mvo_tpu.ops.keypoints import select_keypoints as jax_select
from ur_mvo_tpu.runtime.extractor import NeuralExtractor as JaxExtractor
from ur_mvo_tpu_torch import components as tcomp
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.engine import UR_MVO
from ur_mvo_tpu_torch.ops.gridsample import patch_descriptors
from ur_mvo_tpu_torch.ops.keypoints import select_keypoints
from ur_mvo_tpu_torch.ops.nms import simple_nms
from ur_mvo_tpu_torch.runtime.extractor import NeuralExtractor, OracleExtractor
from ur_mvo_tpu_torch.utils import synthscene


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP_V3 = os.path.join(REPO, "weights", "superpoint_scratch_v3.npz")
SG_CKPT = os.path.join(REPO, "weights", "superglue_v3scene.npz")
H, W, FX = 120, 160, 130.0


# --- sub-pixel peaks ----------------------------------------------------------

def _gaussian_peak():
    """``tests/test_camera.py::test_subpixel_keypoint_refinement``: a
    Gaussian peak at (31.3, 22.6), NMS stood in by its global max."""
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float64)
    raw = np.exp(-((xx - 31.3) ** 2 + (yy - 22.6) ** 2) / (2 * 1.5**2)).astype(np.float32)
    nms = np.where(raw >= raw.max(), raw, 0.0).astype(np.float32)
    return raw, nms, dict(capacity=8, threshold=0.1, border=2, max_keypoints=8)


def _random_peaks():
    """Smoothed noise through the port's NMS: many peaks, some at the
    image's edge (the fit's clamped neighbourhood) and on plateaus."""
    rng = np.random.default_rng(3)
    raw = rng.random((48, 64)).astype(np.float32)
    raw = (raw + np.roll(raw, 1, 0) + np.roll(raw, 1, 1)) / 3.0
    raw[10:13, 20:23] = 0.9  # a plateau: the fit's guarded denominator
    nms = simple_nms(torch.from_numpy(raw)[None], radius=2)[0].numpy()
    return raw, nms, dict(capacity=64, threshold=0.5, border=0, max_keypoints=60)


@pytest.mark.parametrize("case", [_gaussian_peak, _random_peaks], ids=["gaussian_peak", "random_peaks"])
def test_subpixel_fit_matches_jax(case):
    """Sub-pixel keypoints within 1e-5 px of the JAX package's, the integer
    picks equal, offsets within +-0.5 px; the Gaussian peak found to 0.05 px
    as ``test_camera.py`` requires, and integer keypoints without raw scores."""
    raw, nms, kw = case()
    desc_map = np.random.default_rng(0).normal(size=(48 // 8, 64 // 8, 16)).astype(np.float32)
    tb = select_keypoints(torch.from_numpy(nms), torch.from_numpy(desc_map), raw_scores=torch.from_numpy(raw), **kw)
    jb = jax_select(jnp.asarray(nms), jnp.asarray(desc_map), raw_scores=jnp.asarray(raw), **kw)
    ti = select_keypoints(torch.from_numpy(nms), torch.from_numpy(desc_map), **kw)
    v = tb.valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(jb.valid))
    assert v.sum() >= 1
    k, ki = tb.kpts.numpy()[v], ti.kpts.numpy()[v]
    np.testing.assert_allclose(k, np.asarray(jb.kpts)[v], atol=1e-5)
    np.testing.assert_allclose(tb.desc.numpy(), np.asarray(jb.desc), atol=1e-5)
    assert (ki == np.round(ki)).all() and (np.abs(k - ki) <= 0.5).all()
    if case is _gaussian_peak:
        assert len(k) == 1 and abs(k[0, 0] - 31.3) < 0.05 and abs(k[0, 1] - 22.6) < 0.05


# --- patch descriptors --------------------------------------------------------

def test_patch_descriptors_match_jax():
    """Keypoints inside, on and past the image's edge: within 1e-5 of the
    JAX package's; (K, 256), unit norm, zero mean (``test_patch_desc.py``)."""
    rng = np.random.default_rng(0)
    img = rng.random((120, 160)).astype(np.float32)
    kpts = np.concatenate([rng.uniform(20, 100, (28, 2)), [[0, 0], [159, 119], [-3, 50], [162, 121]]]).astype(np.float32)
    d = patch_descriptors(torch.from_numpy(img), torch.from_numpy(kpts))
    assert d.shape == (32, 256) and d.dtype == torch.float32
    np.testing.assert_allclose(d.numpy(), np.asarray(jax_patch(jnp.asarray(img), jnp.asarray(kpts))), atol=1e-5)
    np.testing.assert_allclose(torch.linalg.vector_norm(d, dim=1).numpy(), 1.0, atol=1e-4)
    np.testing.assert_allclose(d.mean(dim=1).numpy(), 0.0, atol=1e-5)


def test_patch_descriptors_match_under_translation():
    """``test_patch_desc.py::test_patch_descriptors_match_under_translation``
    on the port."""
    rng = np.random.default_rng(1)
    base = rng.random((160, 200)).astype(np.float32)
    dx, dy = 7, 4
    img0 = torch.from_numpy(base)
    img1 = torch.from_numpy(np.roll(np.roll(base, dy, axis=0), dx, axis=1))
    kpts0 = torch.from_numpy(rng.uniform(30, 120, (24, 2)).astype(np.float32))
    d0 = patch_descriptors(img0, kpts0)
    d1 = patch_descriptors(img1, kpts0 + torch.tensor([dx, dy], dtype=torch.float32))
    assert torch.sum(d0 * d1, dim=1).min() > 0.99
    d_far = patch_descriptors(img1, kpts0 + torch.tensor([40.0, 55.0]))
    assert torch.sum(d0 * d_far, dim=1).abs().max() < 0.6


# --- resolution buckets -------------------------------------------------------

def _cfg(Configs, buckets=None, subpixel=False, patch=False):
    cfg = Configs()
    cfg.superpoint.weights_path = SP_V3
    cfg.superpoint.capacity = 512
    cfg.superpoint.max_keypoints = 400
    cfg.superpoint.keypoint_threshold = 1e-4
    cfg.superpoint.resolution_buckets = buckets
    cfg.superpoint.subpixel = subpixel
    cfg.superpoint.descriptor_source = "patch" if patch else "network"
    cfg.superglue.image_width, cfg.superglue.image_height = W, H
    cfg.runtime.compute_dtype = "float32"
    return cfg


def _distortion_map():
    """A mild calibrated rectify map over the 120x160 sensor: source pixels
    pulled toward the centre by up to ~1.5 px."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    r2 = ((xx - W / 2) ** 2 + (yy - H / 2) ** 2) / (W / 2) ** 2
    return np.stack([W / 2 + (xx - W / 2) * (1 - 0.01 * r2), H / 2 + (yy - H / 2) * (1 - 0.01 * r2)], -1)


@pytest.fixture(scope="module")
def frames():
    images, _, _ = synthscene.render_sequence(2, H, W, FX, seed=0)
    return images


@pytest.mark.parametrize("options", [{}, {"subpixel": True, "patch": True, "mask": True}],
                         ids=["network", "subpixel_patch_mask"])
def test_bucketed_extraction_matches_jax(frames, options):
    """A 120x160 frame (and a 112x150 crop of it) through a (128, 192)
    bucket, with a calibrated rectify map, in both packages: the same
    valid count, the same keypoint in the same slot in >= 99% of valid
    slots (within 1e-4 px with sub-pixel peaks), scores and descriptors to
    1e-4; every keypoint inside the true image less its border."""
    mask = None
    if options.get("mask"):
        mask = np.ones((H, W), np.uint8)
        mask[:30, :40] = 0
    rect = _distortion_map()
    jcam, tcam = jax_pinhole(W, H, FX, FX, W / 2, H / 2), make_pinhole(W, H, FX, FX, W / 2, H / 2)
    jcam.undistort_map, tcam.undistort_map = rect, rect
    kw = dict(buckets=[(128, 192), (256, 320)], subpixel=options.get("subpixel", False), patch=options.get("patch", False))
    jx = JaxExtractor(_cfg(jconfig.Configs, **kw), jcam)
    tx = NeuralExtractor(_cfg(tconfig.Configs, **kw), tcam, device="cpu")
    for img in (frames[0], frames[1][: H - 8, : W - 10]):
        m = None if mask is None else mask[: img.shape[0], : img.shape[1]]
        a, b = jx.extract(img, m), tx.extract(img, m)
        va, vb = np.asarray(a.valid), b.valid.numpy()
        assert va.sum() == vb.sum() > 80
        ka, kb = np.asarray(a.kpts), b.kpts.numpy()
        same = (np.abs(ka - kb) <= 1e-4).all(-1) & va
        assert same.sum() / va.sum() >= 0.99
        np.testing.assert_allclose(b.desc.numpy()[same], np.asarray(a.desc)[same], atol=1e-4)
        np.testing.assert_allclose(b.scores.numpy()[same], np.asarray(a.scores)[same], atol=1e-4)
        h, w = img.shape
        assert (kb[vb, 0] <= w - 4).all() and (kb[vb, 1] <= h - 4).all()
        if mask is not None:
            assert not ((kb[vb, 0] < 40) & (kb[vb, 1] < 30)).any()
    assert sorted(tx._bucket_progs) == [(128, 192, False)]
    # the calibrated map over the top-left crop, identity over the pad
    bucket_map = tx._bucket_progs[(128, 192, False)].numpy()
    np.testing.assert_array_equal(bucket_map[:H, :W], rect)
    yy, xx = np.mgrid[0:128, 0:192].astype(np.float32)
    np.testing.assert_array_equal(bucket_map[H:], np.stack([xx, yy], -1)[H:])
    np.testing.assert_array_equal(bucket_map[:, W:], np.stack([xx, yy], -1)[:, W:])


def test_bucket_choice_and_refusals(frames):
    """The smallest-AREA bucket that fits (not the first in sort order); a
    ValueError when none fits; buckets that are not multiples of 8 refused
    at construction (the encoder's pools and the stage kernel need them)."""
    cam = make_pinhole(W, H, FX, FX, W / 2, H / 2)
    tx = NeuralExtractor(_cfg(tconfig.Configs, buckets=[(128, 480), (256, 192)]), cam, device="cpu")
    bank = tx.extract(frames[0])
    assert sorted(tx._bucket_progs) == [(256, 192, False)]  # 49,152 px, not 61,440
    assert int(bank.num_valid()) > 80
    with pytest.raises(ValueError, match="exceeds every resolution bucket"):
        tx.extract(np.zeros((300, 160), np.uint8))
    with pytest.raises(ValueError, match="multiples of 8"):
        NeuralExtractor(_cfg(tconfig.Configs, buckets=[(124, 160)]), cam, device="cpu")


def test_bucketed_extraction_matches_native(frames):
    """``tests/test_resolution_buckets.py::test_bucketed_extraction_matches_native``
    on the port at 120x160 in a (128, 192) bucket: interior keypoints (away
    from the pad seam's receptive field) agree with the native extraction."""
    cam = make_pinhole(W, H, FX, FX, W / 2, H / 2)
    b0 = NeuralExtractor(_cfg(tconfig.Configs), cam, device="cpu").extract(frames[0])
    b1 = NeuralExtractor(_cfg(tconfig.Configs, buckets=[(128, 192)]), cam, device="cpu").extract(frames[0])
    k0 = b0.kpts.numpy()[b0.valid.numpy()]
    k1 = b1.kpts.numpy()[b1.valid.numpy()]
    assert (k1[:, 0] <= W - 4).all() and (k1[:, 1] <= H - 4).all()
    interior = (k0[:, 0] < W - 48) & (k0[:, 1] < H - 48)
    assert interior.sum() > 50
    d = np.abs(k0[interior][:, None, :] - k1[None, :, :]).sum(-1).min(1)
    assert (d < 0.5).mean() > 0.99


# --- the defaults keep their bits ---------------------------------------------

def _digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# sha256 of the outputs below as commit 94cb04a's port gives them on the CPU
# (one intra-op thread), before sub-pixel peaks, patch descriptors, buckets
# and local-map tracking were ported
DEFAULT_DIGESTS = {
    "extract": "10aa11cdca8766cd53a928f0b3bdc513758a4a17f1640560d02e5cc56612a9a8",
    "frame_steps": "dc8f8f4483eb465738d403285a5950b1acde26c5fa87390700ae7f31cd1840af",
    "keyframes": "3674c4c9e999576a3fb5dbf4a12fdd0cc8078003c0c94f249b0c6dd71e042d8f",
    "oracle_keyframes": "4c5c7244267e37b89c215febdfac4ca901de7ff27d9e92cad7f9692abf46118c",
}


def _default_cfg():
    c = tconfig.Configs()
    c.superpoint.weights_path = SP_V3
    c.superglue.weights_path = SG_CKPT
    c.superpoint.capacity = 256
    c.superpoint.max_keypoints = 250
    c.superpoint.keypoint_threshold = 1e-4
    c.superglue.matching_threshold = 0.2
    c.initializer.min_matches = 30
    c.initializer.min_features_first = 60
    c.keyframe.max_num_passed_frame = 3
    return c


def test_defaults_keep_their_bits():
    """Every new option at its default (no buckets, no sub-pixel, network
    descriptors, local map off): ``NeuralExtractor.extract`` on two frames,
    the fused frame step's packed outputs and the keyframes of a 6-frame
    neural run (bf16, shipped weights), and the keyframes of a 20-frame
    oracle run (the two-program flow) hash to 94cb04a's digests."""
    images, _, _ = synthscene.render_sequence(6, H, W, FX, seed=0, n_planes=3, z_background=6.0)
    cam = make_pinhole(W, H, FX, FX, W / 2, H / 2)
    ext = NeuralExtractor(_default_cfg(), cam, device="cpu")
    got = {"extract": _digest([t.numpy() for b in (ext.extract(im) for im in images[:2]) for t in b])}
    vo = UR_MVO(_default_cfg(), tconfig.SensorSetup.MONO, camera=cam, device="cpu")
    packed = []
    step = vo.tracker._fused_kernel

    def keep(*args, **kw):
        out = step(*args, **kw)
        packed.append(out[0].numpy().copy())
        return out

    vo.tracker._fused_kernel = keep
    for i, im in enumerate(images):
        vo.process(tcomp.Frame(image=tcomp.Image(im, i / 30.0)))
    assert len(packed) == 3
    got["frame_steps"] = _digest(packed)
    got["keyframes"] = _digest(vo.keyframe_trajectory())

    rng = np.random.default_rng(1)
    X = np.stack([rng.uniform(-4, 6, 300), rng.uniform(-3, 3, 300), rng.uniform(4, 9, 300)], 1).astype(np.float32)
    ocam = make_pinhole(640, 512, 400.0, 400.0, 320.0, 256.0)
    oc = tconfig.Configs()
    oc.superpoint.capacity = 512
    oc.superpoint.max_keypoints = 512
    oc.backend.ba_max_points = 512
    oc.backend.ba_max_observations = 4096
    ovo = UR_MVO(oc, tconfig.SensorSetup.MONO, camera=ocam,
                 extractor=OracleExtractor(X, ocam, capacity=512, noise_px=0.2, seed=3, device="cpu"), device="cpu")
    for i in range(20):
        T = np.eye(4)
        T[0, 3] = 0.05 * i
        T[1, 3] = 0.2 * np.sin(0.1 * i)
        f = tcomp.Frame(image=tcomp.Image(np.zeros((2, 2), np.uint8), i / 30.0))
        f.meta["T_wc"] = T
        ovo.process(f)
    got["oracle_keyframes"] = _digest(ovo.keyframe_trajectory())
    assert got == DEFAULT_DIGESTS
