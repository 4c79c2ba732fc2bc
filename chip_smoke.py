#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``ur_mvo_tpu_torch``) on one card: its
kernels, its front end, the whole monocular engine and its long,
loop-bearing protocol with global optimization.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It needs one CUDA device, the CUDA toolkit (``nvcc``) and ``ninja``; it
builds the port's kernels from ``ur_mvo_tpu_torch/csrc/`` with
``torch.utils.cpp_extension.load`` into
``build/ur_mvo_tpu_torch_ext/`` and runs at the validated mono operating
point: 240x320, the shipped ``superpoint_scratch_v3`` / ``superglue_v3scene``
weights, capacity 1024, 1000 keypoints, threshold 1e-4, 18 attention
layers, bf16 compute. Phases, each printing one JSON line:

1. device: the card's name, count and power limit;
2. build: time to compile the kernels;
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shapes, in bf16 and float32 (max error beside its bound; for
   the encoder stages also ragged shapes (64x80, 66x90, 480x640 at B = 2),
   the errors of conv_b fed the previous tap's weights and, where a stage
   runs as a thread-block cluster, of each block without its peer's
   channels, which must exceed the bound, a bitwise repeat, the blocks
   launched, blocks per SM, registers and shared memory of each shape, and
   the output bits as ``STAGE_CONV_DIGEST`` records them; for attention,
   the main path's bf16 kernel and the key-group kernel beside it, also
   ragged query and key counts and the errors of a swapped mask,
   of a dropped first key tile, of a dropped last step and of a dropped last
   key group, which must exceed the bound; two launches bit for bit equal;
   no other kernel in its wrapper calls; blocks per SM and registers per
   thread; its time over SDPA's; the main path's output bits as
   ``ATTENTION_DIGEST`` records them); for Sinkhorn (one cooperative
   launch) the matcher's transport at capacity 1024 and random couplings at
   ragged shapes, a single row and 2049 x 2049 (the streamed route), with
   blocks, registers, shared memory and route per shape, a control whose
   column sweeps read the previous iteration's u (it must miss the bound and
   the digest), a bitwise repeat, one device record a wrapper call, the
   output bits as ``SINKHORN_DIGEST`` records them, and its time beside an
   empty kernel of 40 grid barriers on the same grid; each kernel's
   device time per launch from ``torch.profiler`` beside the plain version's
   and, where one exists, a PyTorch library call's, the wall time of a
   wrapper call, and the least time the card could take (``bound_ms``).
   The pose-GN kernel runs a problem of 300 tracks (half stereo rows, 30
   outliers, 20 invalid), one of 1500, a batch of two at 1024 mono tracks
   and a batch of two problems of which only one repeats its rounds,
   against the plain optimizer's full 4 x 10 schedule: R within 2e-5, t
   within 2e-4, inlier flags equal on >= 99%, two launches bit for bit
   equal, while the plain version cut to one round must miss those limits;
   the plain version's shortcut schedule must give the full one's bits on
   the card; its output bits on ``pose_digest_cases``
   must be those ``POSE_GN_DIGEST`` records (the kernel of commit f0fbc0f),
   which a control whose round-repeat test ignores the Huber flag must
   miss; the GN steps each problem ran per case; its time stands beside the
   bound for the steps these inputs ran and a chain of as many dependent
   reduce-and-publish steps in an empty kernel;
4. frontend: ``NeuralExtractor.extract`` on 8 rendered frames and ``match``
   with F-RANSAC on each consecutive pair, with the launch counts of every
   kernel over that run; fails below 100 keypoints a frame or 60 inliers a
   pair, or if a kernel of the path did not launch;
5. parity: the same frames through the kernels' plain versions on the card;
   keypoint overlap >= 95% and match agreement >= 90%;
6. timing: median and 75th-percentile ms per extract and per match (with
   F-RANSAC), and of the match's parts (SuperGlue scores, RANSAC), on the
   kernel path and on the plain path; then the device's busy and idle share
   of a frame step (extract + match) and its largest kernels, from
   ``torch.profiler``, and the kernels that run right before a match's
   attention kernels (no mask cast may be among them);
7. ba: one window-sized bundle adjustment on the card against the same
   problem on the CPU (to a tolerance: ``index_add_`` adds with atomics);
8. engine: ``UR_MVO(cfg, device="cuda")`` with the production mono
   configuration (matcher ``sg``, relocalization on) on the accuracy
   protocol of ``scripts/bench_accuracy.py`` for the ``mono/3d`` cell (24
   frames at 30 fps, scene seeds 11-13, scale-corrected ATE of the emitted
   trajectory), launch counts reset just before: every run must initialise,
   insert >= 3 keyframes, emit >= 5 finite poses (the protocol's "not
   failed") and, on the kernels, lose at most 6 frames; the mean ATE must stay <= 0.15 (the
   gate of ``tests/test_accuracy_gates.py``); every kernel must launch
   (``pose_gn`` at least once per tracked frame; its mean GN steps per
   problem are printed). Host ms per stage and per
   frame, the device's busy and idle share of a run, and the same sequences
   through the plain versions on the card, held to the same gate. The checked
   runs go under PyTorch's deterministic ``index_add_`` so that they repeat;
   the timed runs do not. Relocalizations are reported per run;
9. long: the ``mono/long`` protocol of ``scripts/bench_accuracy.py --long``
   (its long configuration: culling, loop closure, relocalization, the
   tracking-time NN floor; 120 frames of the out-and-back trajectory at
   480x640, fx 520, seeds 11-13, deterministic algorithms), launch counts
   reset just before: per seed the online ATE of the emitted trajectory,
   ``global_optimize()`` (seconds by part) and the ATE of the keyframe
   trajectory after it, loop edges, relocalizations, frames lost and the
   full BA's size and resolved assembly. Gate of
   ``tests/test_accuracy_gates.py``: no failed seed, online mean < 1.2,
   after global optimization < 0.60 and < online; every kernel of the path
   must launch. Its full BA stays far under the 128M-element line (~500
   points, culling on), so it takes the float32 ``index_add_`` route, and
   the phase says so; then ``Backend.global_optimize()`` on a long map
   past the line (41 keyframes of the out-and-back path, ~10,000 points
   seen twice or more, drifted as mono VO drifts, one loop edge), launch
   counts reset just before: its full BA must resolve to ``"sorted"`` and
   launch the sorted kernel, keyframes and points within phase 7's limits
   of the same call with ``kernels=False``, keyframe ATE lower after it;
10. ba_kernels: both BA point-reduce kernels against their plain versions
   at that full BA's shape (its power-of-two buckets) and at a global BA's
   (65,536 points, 524,288 observations, FF 48): within 1e-5 of max
   |plain|, the sorted kernel bit for bit equal over two launches, points
   without observations exact zeros, and a slot id or a point rank off by
   one must miss the limit; device ms after a read that evicts the L2
   (and back to back), wall, plain, the ``index_add_`` yardstick and the
   bound;
11. global_ba: ``bundle_adjust`` at that global size: ``"auto"`` must
   resolve to ``"sorted"`` and launch the sorted kernel, and its solution
   must agree with the plain assembly on the card (R 1e-3, t 1e-3, X 5e-3,
   inliers >= 99%) and reach the truth (t 5e-2, R 5e-3); the explicit
   ``"pallas"`` (the unsorted kernel, atomics) likewise with its worst
   point within 5e-2, a limit that the plain assembly on shuffled
   observations must meet and a wrong slot assembly must miss; host ms.

Then each phase's seconds, the ``kernels`` line (launches from the engine
run; the sorted reduction's from the long map's ``global_optimize``, the
unsorted one's from the ``"pallas"`` global BA; times at the global
shape), the ``nvidia-smi`` name/power-limit line, and as the last line ``{"ok": true, "device": {...}}``. A failed check prints a
``{"phase": ..., "failed": ...}`` line and the run goes on to the next
phase; at the end any failure makes the exit code 1 and leaves the
``kernels`` and last lines out. An error that is not a check raises. Without CUDA it exits
with code 2 before doing anything. ``--only-pose-gn`` builds, checks the
pose-GN kernel and stops: the short first run after an edit to it.
``--engine-seeds 0,11,12 [--repeats N] [--deterministic]`` builds and runs the
engine N times on each of those scenes (and once on the plain versions),
printing each run's keyframes, frames lost and ATE: the spread from one run
to the next.
``--long-seeds 11,12,...,20 [--plain]`` runs the long protocol on those
scenes, on the kernels or on their plain versions, printing each run's
online and after-``global_optimize`` ATE: the seed-to-seed spread behind
the long gate; ``--attention kernel|split|plain`` routes only the matcher's
attention (the main path's kernel, the key-group kernel, the plain
version), and ``--audit`` holds both bf16 attention kernels against the
plain version on every attention call of those runs, a line per layer.
``--only-attention`` builds and runs the attention checks of phase 3;
``--only-stage-conv`` those of the encoder stages, ``--only-sinkhorn``
those of Sinkhorn. ``--stage-digest`` prints ``stage_conv_digest()`` alone,
``--sinkhorn-digest`` ``sinkhorn_digest()`` with the time of a call,
``--pose-gn-digest`` ``pose_gn_digest()`` with the device and wall time of a
call at B = 2, N = 1024 (all three run in an older checkout too: copy this
file into one and run it there to take that kernel's digest).
``--only-ba-kernels`` builds and checks the two point-reduce kernels;
``--only-ba`` also runs the long map's ``global_optimize`` and global_ba.
``--ptxas`` prints registers and shared memory per kernel.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
SP_WEIGHTS = os.path.join(REPO, "weights", "superpoint_scratch_v3.npz")
SG_WEIGHTS = os.path.join(REPO, "weights", "superglue_v3scene.npz")
H, W, FX = 240, 320, 260.0
N_FRAMES = 8
MIN_KEYPOINTS = 100
MIN_INLIERS = 60  # superglue_v3scene's __meta_op_min_matches__
# the accuracy protocol of scripts/bench_accuracy.py for the mono/3d cell: 24
# frames at 30 fps, scene seeds 11-13, ATE of the emitted trajectory; the gate
# of tests/test_accuracy_gates.py: no failed seed, mean ATE under 0.15
ENGINE_FRAMES = 24
ENGINE_SEEDS = (11, 12, 13)
FPS = 30.0
MAX_ATE = 0.15
MIN_KEYFRAMES = 3
MAX_FRAMES_LOST = ENGINE_FRAMES // 4
# the long protocol of scripts/bench_accuracy.py --long: 120 frames of the
# out-and-back trajectory at 480x640, fx 520, seeds 11-13; the gate of
# tests/test_accuracy_gates.py for mono/long sg: no failed seed, online
# mean ATE < 1.2, mean ATE after global optimization < 0.60 and < online
LONG_W, LONG_H, LONG_FX = 640, 480, 520.0
LONG_FRAMES = 120
LONG_MAX_ONLINE, LONG_MAX_PGO = 1.2, 0.60

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32 CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

TPU_KERNELS = {
    "stage1_conv": "ur_mvo_tpu/ops/pallas_conv.py:106",
    "stage_conv": "ur_mvo_tpu/ops/pallas_conv.py:140",
    "attention": "ur_mvo_tpu/ops/pallas_kernels.py:122",
    "sinkhorn": "ur_mvo_tpu/ops/pallas_kernels.py:31",
    "pose_gn": "ur_mvo_tpu/ops/pallas_pose.py:93",
    "point_reduce_sorted": "ur_mvo_tpu/ops/pallas_ba.py:141",
    "point_reduce": "ur_mvo_tpu/ops/pallas_ba.py:38",
}
SOURCES = {
    "stage1_conv": "ur_mvo_tpu_torch/csrc/stage_conv.cu",
    "stage_conv": "ur_mvo_tpu_torch/csrc/stage_conv.cu",
    "attention": "ur_mvo_tpu_torch/csrc/attention.cu",
    "sinkhorn": "ur_mvo_tpu_torch/csrc/sinkhorn.cu",
    "pose_gn": "ur_mvo_tpu_torch/csrc/pose_gn.cu",
    "point_reduce_sorted": "ur_mvo_tpu_torch/csrc/point_reduce.cu",
    "point_reduce": "ur_mvo_tpu_torch/csrc/point_reduce.cu",
}
ENGINE_KERNELS = ("stage1_conv", "stage_conv", "attention", "sinkhorn", "pose_gn")
# (P, O, FF) of the point-reduce kernels' checks: a long sequence's full BA
# past the 128M-element line (the main run takes the long run's own full-BA
# shape in its place) and a global BA over a long sequence, 65,536 points and
# 524,288 observations (the size ur_mvo_tpu/ops/ba.py:580-583 names)
BA_KERNEL_SHAPES = ((16384, 65536, 48), (65536, 524288, 48))
# that global BA as a problem: points, observations per point, keyframes;
# the keyframes' spacing in metres
GLOBAL_BA = (65536, 8, 48)
SPACING = 0.2
# the unsorted kernel's BA at that size against the plain assembly: the
# worst point's limit, in metres (0.5 px at 6-12 m and fx 400 leaves a
# point seen over a few metres of baseline a depth sigma of 5-10 cm)
PALLAS_X = 5e-2
# phase 9's long map: scene points, features observed a keyframe
LONG_MAP = (14000, 1000)
# sha256 of attention_digest(): the main path's bf16 attention outputs as the
# tile-by-tile kernel of commit b873c7a gives them. The long protocol's gate
# was set on those bits, and a change of them moves its 3-seed mean by up
# to ~0.2 (PERF.md, section 6), so the main path keeps them.
ATTENTION_DIGEST = "f1cc34280e833d06d15dd221a3f368967b379bcfbee5cae34c2977e98df135bf"
# SuperPoint's encoder stages: the convs of each
STAGE_CONVS = {"stage1": ("conv1a", "conv1b"), "stage2": ("conv2a", "conv2b"), "stage3": ("conv3a", "conv3b")}
# (B, H, W) of the stage kernel's ragged checks: tiles cut by the image's
# edge (66x90 leaves 33x45 pooled outputs) and the long protocol's 480x640
STAGE_RAGGED = ((1, 64, 80), (2, 66, 90), (2, 480, 640))
# sha256 of stage_conv_digest(): the bf16 stage outputs as the kernel of
# commit 8f88b95 gives them, that commit's stage_conv.cu built on the card
# beside this one (``python3 chip_smoke.py --stage-digest`` from a checkout
# of it). The gates of phases 8-9 were set on those bits, so the stage
# kernel keeps them.
STAGE_CONV_DIGEST = "faa335d60a5204a04f7ba45f2d2d5fe1ceacff1ed98898735590e26de91f8e29"
# Sinkhorn's checks: the matcher's transport at capacity 1024 (valid
# keypoints of each frame), and random couplings: the timing shape, ragged
# bands, a single row, and 2049 x 2049 (capacity 2048, the largest the
# configuration takes), whose bands do not both fit in shared memory
SINKHORN_TRANSPORTS = ((1000, 1000), (950, 1000))
SINKHORN_SHAPES = ((1025, 1025), (257, 301), (1025, 513), (1, 1), (1, 300), (2049, 2049))
# sha256 of sinkhorn_digest(): the output bits of the launch-a-half-sweep
# kernel of commit 81bee71, that commit's sinkhorn.cu built on the card
# (``python3 chip_smoke.py --sinkhorn-digest`` from a checkout of it). The
# gates of phases 8-9 were set on those bits, so the kernel keeps them.
SINKHORN_DIGEST = "4eb89b3c3fe7a6a37a4bd4f1d71187fb6467195f3aa7f46f9f68c2450bd04075"
# that kernel's device and wall ms a call at 1025 x 1025, 20 iterations
# (PERF.md, section 6, row 3): printed beside this kernel's
SINKHORN_BEFORE = (0.2086, 0.274)
# sha256 of pose_gn_digest(): the output bits of the pose-GN kernel of commit
# f0fbc0f (every step two passes and two reductions, all 40 steps), that
# commit's pose_gn.cu built on the card (``python3 chip_smoke.py
# --pose-gn-digest`` from a checkout of it). The gates of phases 8-9 were set
# on those bits, so the kernel keeps them.
POSE_GN_DIGEST = "e835064b9dd544703f0cea51ee47f4bd501544b4dcc1a4248a1992d414eda6c3"
# that kernel's device and wall ms a call at B = 2, N = 1024 (PERF.md,
# section 6, row 5): printed beside this kernel's
POSE_GN_BEFORE = (0.1841, 0.283)



def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def profile_device(fn, calls: int):
    """Run ``fn`` ``calls`` times under ``torch.profiler`` (after a warm-up).
    Returns {device kernel name: total microseconds}, {host op name: total
    self microseconds, plus "device records": the number of kernels, copies
    and sets the device ran} and the wall ms. Only device-side records count as
    device time (a host op's own "device time" would count its kernels twice)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device, host = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) + e.time_range.elapsed_us()
            host["device records"] = host.get("device records", 0) + 1
        elif e.device_type == DeviceType.CPU:
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
    return device, host, wall


def device_kernels(fn, opener: bool = False):
    """Names of the device records of a call of ``fn`` under the profiler
    (after a warm-up call), in the order they started. The profiler can drop
    the first record of a window: ``opener`` starts the window with a fill
    of one element, whose record is left out, so that every record of
    ``fn`` is kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    marker = torch.empty(1, device="cuda") if opener else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if opener:
            marker.fill_(0.0)
        fn()
        torch.cuda.synchronize()
    records = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = [e.name for e in sorted(records, key=lambda e: e.time_range.start)]
    return names[1:] if opener and names and "Fill" in names[0] else names


def device_ms(fn, names=None, calls: int = 20, exclude=()):
    """Device time per call of ``fn`` from the profiler's kernel records: of
    the kernels whose name contains one of ``names``, or of every kernel,
    leaving out those whose name contains one of ``exclude``. Where the
    profiler records no device time, CUDA events around back-to-back calls
    instead (returned with the timer's name)."""
    by_name, _, _ = profile_device(fn, calls)
    us = sum(v for k, v in by_name.items()
             if (names is None or any(n in k for n in names)) and not any(x in k for x in exclude))
    if us > 0:
        return us / 1e3 / calls, "profiler"
    return time_ms(fn), "events"


def timings(kernel, names, plain, library=None, plain_calls: int = 20, cold_l2: bool = False):
    """``ms``: device time per call of the kernel's own CUDA kernels;
    ``wall_ms``: CUDA-event time per wrapper call, back to back (host work
    included); ``plain_ms`` / ``library_ms``: device time per call of every
    kernel the plain version / the library call runs. ``cold_l2``: each
    timed call follows a read of 256 MB (five times the L2), whose kernel
    is left out of the times, so that a kernel whose output fits in L2 does
    not find the previous call's there; the back-to-back reading is kept as
    ``ms_back_to_back``."""
    out = {"wall_ms": time_ms(kernel)}
    flush = ()
    if cold_l2:
        import torch

        l2 = torch.ones((16384, 4096), device="cuda")
        flush = ("at::native::reduce_kernel",)
        out["ms_back_to_back"] = device_ms(kernel, names)[0]

        def cold(fn):
            def run():
                l2.sum(1)
                return fn()
            return run

        kernel, plain, library = cold(kernel), cold(plain), library and cold(library)
    ms, timer = device_ms(kernel, names)
    return {
        "ms": ms, "timer": timer,
        "plain_ms": device_ms(plain, calls=plain_calls, exclude=flush)[0],
        "library_ms": None if library is None else device_ms(library, exclude=flush)[0],
        **out,
    }


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def front_end_config(Configs, width=W, height=H):
    cfg = Configs()
    cfg.superpoint.weights_path = SP_WEIGHTS
    cfg.superglue.weights_path = SG_WEIGHTS
    cfg.superpoint.capacity = 1024
    cfg.superpoint.max_keypoints = 1000
    cfg.superpoint.keypoint_threshold = 1e-4
    cfg.superglue.image_width, cfg.superglue.image_height = width, height
    cfg.runtime.compute_dtype = "bfloat16"
    return cfg


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def shipped_superpoint():
    import torch

    from ur_mvo_tpu_torch.models.superpoint import SuperPoint, load_torch_weights

    sp = SuperPoint()
    sp.load_state_dict(load_torch_weights(SP_WEIGHTS))
    return sp.to(device="cuda", dtype=torch.bfloat16)


def stage_convs(sp, name):
    na, nb = STAGE_CONVS[name]
    return getattr(sp, na), getattr(sp, nb)


def stage_conv_digest():
    """sha256 of the bf16 stage kernel's outputs with the shipped weights:
    stages 1, 2, 3 chained as the backbone chains them, on rendered frames
    (seed 0) at 240x320 and 480x640, B = 1 and B = 2, with a short digest of
    each output beside. It calls only what the stage wrapper has always taken
    (``pack_stage``, ``stage_conv(packed=)``), so the same function digests
    an older checkout's kernel."""
    import hashlib

    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops import cuda_conv
    from ur_mvo_tpu_torch.utils.synthscene import render_sequence

    sp = shipped_superpoint()
    digest, parts = hashlib.sha256(), {}
    for h, w, fx in ((H, W, FX), (LONG_H, LONG_W, LONG_FX)):
        images, _, _ = render_sequence(2, h, w, fx, seed=0)
        for B in (1, 2):
            x = (torch.from_numpy(np.asarray(images[:B])).cuda().float() / 255.0).to(torch.bfloat16)[..., None]
            for name in STAGE_CONVS:
                ca, cb = stage_convs(sp, name)
                args = (ca.weight, ca.bias, cb.weight, cb.bias)
                x = cuda_conv.stage_conv(x, *args, packed=cuda_conv.pack_stage(*args, x.dtype))
                out = x.view(torch.int16).cpu().numpy().tobytes()
                digest.update(out)
                parts[f"{h}x{w} B{B} {name}"] = hashlib.sha256(out).hexdigest()[:16]
    return digest.hexdigest(), parts


def stage_plain_variant(x, wa, ba, wb, bb, tap_shift=0, cluster=1):
    """The plain stage (``cuda_conv.stage_conv_plain``'s arithmetic) with a
    fault a kernel could have: conv_b's weights taken ``tap_shift`` taps back
    (a wrong weight slot), or each of ``cluster`` slices of the output
    channels computed from its own slice of conv_a's channels alone (a
    cluster block that dropped its peers' channels)."""
    import torch
    import torch.nn.functional as F

    def r(t):
        return t.to(x.dtype).float()

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        a = r(F.relu(F.conv2d(x.float().permute(0, 3, 1, 2), r(wa), r(ba), padding=1)))
        w = r(wb)
        if tap_shift:
            w = w.reshape(*w.shape[:2], 9).roll(tap_shift, -1).reshape(w.shape)
        if cluster > 1:
            co, cm = w.shape[0] // cluster, w.shape[1] // cluster
            keep = torch.zeros(w.shape[:2], device=w.device)
            for k in range(cluster):
                keep[k * co:(k + 1) * co, k * cm:(k + 1) * cm] = 1
            w = w * keep[:, :, None, None]
        b = F.relu(F.conv2d(a, w, r(bb), padding=1))
    return F.max_pool2d(b, 2).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def stage_phase(image):
    """The bf16 stage kernel (the main path) and the float32 one against the
    plain version on the card, stage by stage on a rendered 240x320 frame
    with the shipped weights (each stage fed the plain version's output of
    the one before). Bound: 2^-6 of max |plain|, two bf16 ulps of the
    largest output (the versions sum in another order, which can move conv_a's
    rounding by one ulp, and the output's); 1e-4 of it in float32. Also the
    ragged shapes of ``STAGE_RAGGED`` (random inputs), two controls that must
    miss the bound (conv_b fed the previous tap's weights; where the stage
    runs as a cluster, each block without its peers' channels), the launch
    (blocks, cluster, tiles) and footprint of each shape, a bitwise repeat,
    the times beside the cuDNN sequence and the bound, and the main path's
    output bits as ``STAGE_CONV_DIGEST`` records them."""
    import torch
    import torch.nn.functional as F

    from ur_mvo_tpu_torch.ops import cuda_conv, cuda_ext

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    ext = cuda_ext.extension()
    digest, parts = stage_conv_digest()
    emit({"phase": "kernels", "kernel": "stage_conv", "digest": digest, "expected": STAGE_CONV_DIGEST,
          "digest_parts": parts})
    sp = shipped_superpoint()
    x = (torch.as_tensor(image, device=dev).float() / 255.0).to(torch.bfloat16)[None, :, :, None]
    stage_rows = []
    for name in STAGE_CONVS:
        ca, cb = stage_convs(sp, name)
        args = (x, ca.weight, ca.bias, cb.weight, cb.bias)
        packed = cuda_conv.pack_stage(*args[1:], x.dtype)  # packed once, as SuperPoint does
        out = cuda_conv.stage_conv(*args, packed=packed)
        ref = cuda_conv.stage_conv_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2.0**-6 * ref.float().abs().max().item()
        B, Hs, Ws, Cin = x.shape
        Cmid, Cout = ca.weight.shape[0], cb.weight.shape[0]
        info = ext.stage_conv_info(Cin, Cmid, Cout, B, Hs, Ws)

        def control(**fault):
            return (stage_plain_variant(*args, **fault).float() - ref.float()).abs().max().item()

        controls = {"wrong_tap_err": control(tap_shift=1)}
        if info["cluster"] > 1:
            controls["dropped_peers_err"] = control(cluster=info["cluster"])
        xl = x.permute(0, 3, 1, 2)  # NCHW view of NHWC (channels_last)

        def library():
            a = F.relu(F.conv2d(xl, ca.weight, ca.bias, padding=1))
            b = F.relu(F.conv2d(a, cb.weight, cb.bias, padding=1))
            return F.max_pool2d(b, 2)

        flops = 2.0 * Hs * Ws * 9 * (Cin * Cmid + Cmid * Cout)
        nbytes = 2.0 * (Hs * Ws * Cin + (Hs // 2) * (Ws // 2) * Cout + 9 * (Cin * Cmid + Cmid * Cout) + Cmid + Cout)
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16)
        row = {
            "shape": f"{Hs}x{Ws} {Cin}->{Cmid}->{Cout}", "max_abs_err": err, "tol": tol, **controls,
            "plain_variant_exact": bool(torch.equal(stage_plain_variant(*args), ref)),
            "bitwise_repeat": bool(torch.equal(out, cuda_conv.stage_conv(*args, packed=packed))), **info,
            **timings(lambda: cuda_conv.stage_conv(*args, packed=packed), ("stage_mma_kernel",),
                      lambda: cuda_conv.stage_conv_plain(*args), library),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
        }
        row["ratio_to_library"] = row["ms"] / row["library_ms"]
        emit({"phase": "kernels", "kernel": name, **row})
        if not err <= tol:
            raise AssertionError(f"{name}: kernel vs plain max |err| {err} > {tol}")
        if not (row["plain_variant_exact"] and min(controls.values()) > tol):
            raise AssertionError(f"{name}: tolerance {tol} does not tell a wrong tap or dropped peers from the "
                                 f"right result: {controls}")
        if not row["bitwise_repeat"]:
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        for Br, Hr, Wr in STAGE_RAGGED:
            xr = torch.rand((Br, Hr, Wr, Cin), generator=gen, device=dev).to(torch.bfloat16)
            rargs = (xr,) + args[1:]
            outr = cuda_conv.stage_conv(*rargs, packed=packed)
            refr = cuda_conv.stage_conv_plain(*rargs)
            torch.cuda.synchronize()
            errr = (outr.float() - refr.float()).abs().max().item()
            tolr = 2.0**-6 * refr.float().abs().max().item()
            emit({"phase": "kernels", "kernel": name, "shape": f"{Br}x{Hr}x{Wr}", "max_abs_err": errr, "tol": tolr,
                  "finite": bool(torch.isfinite(outr).all()), **ext.stage_conv_info(Cin, Cmid, Cout, Br, Hr, Wr)})
            if not errr <= tolr:
                raise AssertionError(f"{name} {Br}x{Hr}x{Wr}: kernel vs plain max |err| {errr} > {tolr}")
        # the float32 path (compute_dtype "float32"): CUDA-core loops against
        # the plain version without TF32; the sums differ only in order
        xf = x.float()
        wf = tuple(t.float() for t in args[1:])
        packed32 = cuda_conv.pack_stage(*wf, torch.float32)
        out32 = cuda_conv.stage_conv(xf, *wf, packed=packed32)
        ref32 = cuda_conv.stage_conv_plain(xf, *wf)
        torch.cuda.synchronize()
        err32 = (out32 - ref32).abs().max().item()
        tol32 = 1e-4 * ref32.abs().max().item()
        emit({"phase": "kernels", "kernel": name, "dtype": "float32", "max_abs_err": err32, "tol": tol32,
              "ms": device_ms(lambda: cuda_conv.stage_conv(xf, *wf, packed=packed32), ("stage_fma_kernel",))[0]})
        if not err32 <= tol32:
            raise AssertionError(f"{name} float32: kernel vs plain max |err| {err32} > {tol32}")
        stage_rows.append(row)
        x = ref
    if digest != STAGE_CONV_DIGEST:
        raise AssertionError(f"stage_conv: the bf16 stage outputs changed bits (digest {digest}, expected "
                             f"{STAGE_CONV_DIGEST}); the gates of phases 8-9 were set on those bits")

    def mean_row(rs):
        out = {k: sum(r[k] for r in rs) / len(rs) for k in ("ms", "wall_ms", "plain_ms", "library_ms", "bound_ms")}
        out["max_abs_err"] = max(r["max_abs_err"] for r in rs)
        out["bound_by"] = rs[0]["bound_by"]
        return out

    # one kernel template serves stages 2 and 3: per-launch figures are the mean of the two
    return {"stage1_conv": stage_rows[0], "stage_conv": mean_row(stage_rows[1:])}


def attention_digest():
    """sha256 of the main path's bf16 attention outputs on fixed inputs
    (numpy, seed 7): the main shape with flat and with peaked logits, a bank
    with no valid key and ragged key counts."""
    import hashlib

    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops import cuda_kernels

    rng = np.random.RandomState(7)
    digest = hashlib.sha256()
    for Kq, Kkv, counts, q_scale in ((1024, 1024, (1000, 937), 1.0), (1024, 1024, (1000, 937), 4.0),
                                     (1024, 1024, (0, 0), 1.0), (1000, 777, (700, 777), 1.0),
                                     (200, 130, (130, 77), 1.0)):
        q = q_scale * rng.standard_normal((2, Kq, 4, 64))
        k, v = (rng.standard_normal((2, Kkv, 4, 64)) for _ in range(2))
        q, k, v = (torch.from_numpy(a.astype(np.float32)).cuda().to(torch.bfloat16) for a in (q, k, v))
        valid = (np.arange(Kkv)[None] < np.asarray(counts)[:, None])
        out = cuda_kernels.attention(q, k, v, torch.from_numpy(valid).cuda())
        digest.update(out.view(torch.int16).cpu().numpy().tobytes())
    return digest.hexdigest()


def attention_phase(gen):
    """The bf16 attention kernels (the main path's, and the key-group kernel
    beside it) and the float32 one against the plain version on the card:
    the main path's shape (B=2, H=4, K=1024, d=64, banks with different
    valid counts, so a kernel that read the other batch item's mask would
    disagree), a bank with no valid key, ragged query and key counts
    (Kkv=130 leaves the main path's last step with a tile past the end and
    the key-group kernel's first group with no key) and float32. Bound:
    2^-6 of max |out| in bf16, about two bf16 ulps of the largest output
    (probabilities and outputs round to bf16 at different points in the
    versions); 2e-5 in float32, the JAX package's. At the main shape four
    controls must miss the bound (the plain version with the batch items'
    masks swapped, with the first 64 keys masked, with the last 128 keys
    masked, with the last key group's 256 keys masked: a kernel that dropped
    its first tile, its last step or a group), two launches of each kernel
    must agree bit for bit and wrapper calls must run the kernel and nothing
    else (no mask cast); the main path's outputs must be those of
    ``ATTENTION_DIGEST``; then the times, beside SDPA's."""
    import torch
    import torch.nn.functional as F

    from ur_mvo_tpu_torch.ops import cuda_ext, cuda_kernels

    dev = torch.device("cuda")
    Bb, Hh, d = 2, 4, 64
    main = None
    cases = ((torch.bfloat16, 1024, 1024, (1000, 937)), (torch.bfloat16, 1024, 1024, (0, 0)),
             (torch.bfloat16, 1000, 777, (700, 777)), (torch.bfloat16, 200, 130, (130, 77)),
             (torch.float32, 1024, 1024, (1000, 937)))
    for dtype, Kq, Kkv, counts in cases:
        q = torch.randn((Bb, Kq, Hh, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((Bb, Kkv, Hh, d), generator=gen, device=dev).to(dtype) for _ in range(2))
        valid = torch.arange(Kkv, device=dev)[None] < torch.tensor(counts, device=dev)[:, None]
        ref = cuda_kernels.attention_plain(q, k, v, valid)
        tol = 2e-5 if dtype == torch.float32 else 2.0**-6 * ref.float().abs().max().item()
        bf16 = dtype == torch.bfloat16
        routes = {"attention": False, "attention_split": True} if bf16 else {"attention": False}
        row = {"dtype": str(dtype).split(".")[-1], "Kq": Kq, "Kkv": Kkv, "valid": list(counts), "tol": tol}
        for name, split in routes.items():
            out = cuda_kernels.attention(q, k, v, valid, split=split)
            torch.cuda.synchronize()
            r = {"max_abs_err": (out.float() - ref.float()).abs().max().item(),
                 "finite": bool(torch.isfinite(out).all())}
            if not (r["max_abs_err"] <= tol and r["finite"]):
                emit({"phase": "kernels", "kernel": "attention", **row, name: r})
                raise AssertionError(f"{name} {row['dtype']} Kq={Kq} Kkv={Kkv} valid={counts}: max |err| "
                                     f"{r['max_abs_err']} > {tol} (or not finite)")
            if bf16 and Kkv == 1024 and counts[0]:
                kname = "attention_split_kernel" if split else "attention_mma_kernel"
                r["bitwise_repeat"] = bool(torch.equal(out, cuda_kernels.attention(q, k, v, valid, split=split)))
                # the profiler may drop records of a short window: count what it kept
                names = device_kernels(lambda: [cuda_kernels.attention(q, k, v, valid, split=split) for _ in range(20)])
                r["kernels_in_20_calls"] = sum(kname in n for n in names)
                r["other_kernels_in_20_calls"] = len(names) - r["kernels_in_20_calls"]
                if split:  # the main path's kernel is timed below, beside its plain version and SDPA
                    r["ms"] = device_ms(lambda: cuda_kernels.attention(q, k, v, valid, split=True), (kname,))[0]
                r.update(cuda_ext.extension().attention_occupancy(Kkv, split))
            if split:
                row["split"] = r
            else:
                row.update(r)
        if not bf16:
            row["ms"] = device_ms(lambda: cuda_kernels.attention(q, k, v, valid), ("attention_fma_kernel",))[0]
        if bf16 and Kkv == 1024 and counts[0]:
            def control(mask):
                return (cuda_kernels.attention_plain(q, k, v, mask).float() - ref.float()).abs().max().item()

            first, last, group = valid.clone(), valid.clone(), valid.clone()
            first[:, :64] = False
            last[:, -128:] = False
            group[:, -Kkv // 4:] = False
            row.update({"wrong_mask_err": control(valid.flip(0)), "dropped_tile_err": control(first),
                        "dropped_last_step_err": control(last), "dropped_last_group_err": control(group)})
            mask = torch.where(valid, 0.0, -1e9).to(dtype)[:, None, None, :]
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            flops = 4.0 * Bb * Hh * Kq * Kkv * d
            nbytes = 2.0 * (2 * Bb * Kq * Hh * d + 2 * Bb * Kkv * Hh * d) + Bb * Kkv
            b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16)
            row.update({
                **timings(lambda: cuda_kernels.attention(q, k, v, valid), ("attention_mma_kernel",),
                          lambda: cuda_kernels.attention_plain(q, k, v, valid),
                          lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)),
                # the wrapper as it was: a uint8 cast of the mask before each launch
                "wall_ms_with_mask_cast": time_ms(lambda: cuda_kernels.attention(q, k, v, valid.to(torch.uint8))),
                "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
            })
            row["ratio_to_library"] = row["ms"] / row["library_ms"]
            row["split"]["ratio_to_library"] = row["split"]["ms"] / row["library_ms"]
            row["split"]["ratio_to_main_path"] = row["split"]["ms"] / row["ms"]
            row["digest"] = attention_digest()
            main = dict(row)
        emit({"phase": "kernels", "kernel": "attention", **row})
    controls = {c: main[c] for c in ("wrong_mask_err", "dropped_tile_err", "dropped_last_step_err",
                                     "dropped_last_group_err")}
    if not min(controls.values()) > main["tol"]:
        raise AssertionError(f"attention: tolerance {main['tol']} does not tell a wrong mask, a dropped first tile, "
                             f"a dropped last step or a dropped key group from the right result: {controls}")
    for name, r in (("attention", main), ("attention_split", main["split"])):
        if not r["bitwise_repeat"]:
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        if r["other_kernels_in_20_calls"] or not r["kernels_in_20_calls"]:
            raise AssertionError(f"{name}: 20 wrapper calls ran {r['kernels_in_20_calls']} of its kernels and "
                                 f"{r['other_kernels_in_20_calls']} others")
    if main["digest"] != ATTENTION_DIGEST:
        raise AssertionError(f"attention: the main path's outputs changed bits (digest {main['digest']}, expected "
                             f"{ATTENTION_DIGEST}); the long protocol's gate was set on those bits")
    return main


def kernel_phase(images):
    import torch

    rows = stage_phase(images[0])
    rows["attention"] = attention_phase(torch.Generator(device="cuda").manual_seed(0))
    rows["sinkhorn"] = sinkhorn_phase()
    return rows


# ---------------------------------------------------------------------------
# Phase 3, Sinkhorn: the one-launch kernel against its plain version
# ---------------------------------------------------------------------------

def sinkhorn_inputs(M, N, seed=5):
    """Random (M, N) couplings and (M,), (N,) log-marginals (numpy, standard
    normal) on the card."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    arrays = (rng.standard_normal((M, N)), rng.standard_normal(M), rng.standard_normal(N))
    return tuple(torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays)


def transport_inputs(n0, n1, K=1024, seed=3):
    """The matcher's transport at capacity K: scores 3 x standard normal,
    the first n0 / n1 keypoints valid, dustbin score 1.5."""
    import numpy as np
    import torch

    scores = 3.0 * np.random.RandomState(seed + n0).standard_normal((K, K))
    dev = torch.device("cuda")
    return (torch.from_numpy(scores.astype(np.float32)).to(dev), torch.arange(K, device=dev) < n0,
            torch.arange(K, device=dev) < n1, torch.tensor(1.5, device=dev))


def sinkhorn_digest():
    """sha256 of the Sinkhorn kernel's output bits, with a short digest of
    each part beside: the transport of ``SINKHORN_TRANSPORTS`` (20
    iterations) and random couplings at ``SINKHORN_SHAPES`` (0 and 20
    iterations). It calls only what the Sinkhorn wrappers have always taken
    (``sinkhorn``, ``log_optimal_transport_kernel``), so the same function
    digests an older checkout's kernel."""
    import hashlib

    import torch

    from ur_mvo_tpu_torch.ops import cuda_kernels

    digest, parts = hashlib.sha256(), {}

    def add(name, out):
        b = out.view(torch.int32).cpu().numpy().tobytes()
        digest.update(b)
        parts[name] = hashlib.sha256(b).hexdigest()[:16]

    for n0, n1 in SINKHORN_TRANSPORTS:
        add(f"transport {n0}/{n1}", cuda_kernels.log_optimal_transport_kernel(*transport_inputs(n0, n1), 20))
    for M, N in SINKHORN_SHAPES:
        C, mu, nu = sinkhorn_inputs(M, N)
        for iters in (0, 20):
            add(f"{M}x{N} iters {iters}", cuda_kernels.sinkhorn(C, mu, nu, iters))
    return digest.hexdigest(), parts


def sinkhorn_phase():
    """The Sinkhorn kernel (one cooperative launch) against its plain version
    on the card: the matcher's transport at capacity 1024 (1000/1000 and
    950/1000 valid keypoints) and random couplings at ``SINKHORN_SHAPES``
    (ragged, a single row, 2049 x 2049 on the streamed route), each within
    1e-4 (the JAX package's bound), with its launch: blocks, blocks per SM,
    registers, shared memory, bands and route. The output bits must be those
    of ``SINKHORN_DIGEST``; a control whose column sweeps read the previous
    iteration's u must miss both the digest and the bound; two launches must
    agree bit for bit, and 20 wrapper calls must run 20 kernels and nothing
    else (no memset). Then the times at 1025 x 1025, 20 iterations, beside the
    plain version's, the bound and the yardstick of 40 grid barriers in an
    empty kernel of the same grid."""
    import torch

    from ur_mvo_tpu_torch.ops import cuda_ext, cuda_kernels

    ext = cuda_ext.extension()
    tol, iters = 1e-4, 20
    digest, parts = sinkhorn_digest()
    errs = []
    for n0, n1 in SINKHORN_TRANSPORTS:
        args = transport_inputs(n0, n1)
        couplings, mu, nu, _, pair = cuda_kernels.transport_problem(*args)
        Z = cuda_kernels.log_optimal_transport_kernel(*args, iters)
        Zp = cuda_kernels.log_optimal_transport_kernel(*args, iters, plain=True)
        ref = cuda_kernels.sinkhorn_plain(couplings, mu, nu, iters)
        stale = ext.sinkhorn(couplings, mu, nu, iters, True)
        torch.cuda.synchronize()
        err = (Z - Zp).abs()[pair].max().item()  # valid block + dustbins
        row = {"valid": [n0, n1], "max_abs_err": err, "tol": tol,
               "stale_u_err": (stale - ref).abs()[pair].max().item(),
               "bitwise_repeat": bool(torch.equal(Z, cuda_kernels.log_optimal_transport_kernel(*args, iters)))}
        emit({"phase": "kernels", "kernel": "sinkhorn", **row})
        errs.append(err)
        if not (err <= tol and row["bitwise_repeat"]):
            raise AssertionError(f"sinkhorn valid={n0}/{n1}: max |err| {err} > {tol}, or two launches differ")
        if not row["stale_u_err"] > tol:
            raise AssertionError(f"sinkhorn: the bound {tol} does not tell a column sweep on the previous "
                                 f"iteration's u from the right result ({row['stale_u_err']})")
    for M, N in SINKHORN_SHAPES:
        C, mu, nu = sinkhorn_inputs(M, N)
        out = cuda_kernels.sinkhorn(C, mu, nu, iters)
        ref = cuda_kernels.sinkhorn_plain(C, mu, nu, iters)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        info = ext.sinkhorn_info(M, N)
        route = "resident" if info["cols_resident"] else "streamed"
        emit({"phase": "kernels", "kernel": "sinkhorn", "shape": f"{M}x{N}", "max_abs_err": err, "tol": tol,
              "finite": bool(torch.isfinite(out).all()), "route": route, **info})
        errs.append(err)
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"sinkhorn {M}x{N}: max |err| {err} > {tol} (or not finite)")

    # the control in place of the wrapper: the digest's inputs through
    # column sweeps that read the previous iteration's u
    wrapper = cuda_kernels.sinkhorn
    cuda_kernels.sinkhorn = lambda C, mu, nu, iterations=20, plain=False: ext.sinkhorn(C, mu, nu, iterations, True)
    try:
        stale_digest, _ = sinkhorn_digest()
    finally:
        cuda_kernels.sinkhorn = wrapper
    emit({"phase": "kernels", "kernel": "sinkhorn", "digest": digest, "expected": SINKHORN_DIGEST,
          "stale_u_digest": stale_digest, "digest_parts": parts})

    M = N = 1025
    C, mu, nu = sinkhorn_inputs(M, N)
    names = device_kernels(lambda: [cuda_kernels.sinkhorn(C, mu, nu, iters) for _ in range(20)], opener=True)
    launched = sum("sinkhorn_kernel" in n for n in names)
    ops = iters * 2 * M * N * 6 + 2 * M * N  # per element and half-sweep: add, max; add, sub, exp, add
    nbytes = 4.0 * (2 * M * N + 2 * (M + N))
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_F32)
    row = {
        "shape": f"{M}x{N}", "iters": iters, "max_abs_err": max(errs),
        "kernels_in_20_calls": launched, "other_records_in_20_calls": len(names) - launched,
        **timings(lambda: cuda_kernels.sinkhorn(C, mu, nu, iters), ("sinkhorn_kernel",),
                  lambda: cuda_kernels.sinkhorn_plain(C, mu, nu, iters), plain_calls=3),
        "bound_ms": b_ms, "bound_by": b_by,
        # 2 x iters grid barriers alone, in an empty kernel of the same grid
        "barriers_ms": device_ms(lambda: ext.sinkhorn_barriers(C, M, N, iters), ("barrier_kernel",))[0],
        # the earlier design's yardstick: the matrix read from L2 once a half-sweep
        "l2_sweeps_ms": device_ms(lambda: C.expand(2 * iters, M, N).sum())[0],
        "before_ms": SINKHORN_BEFORE[0], "before_wall_ms": SINKHORN_BEFORE[1],
        **ext.sinkhorn_info(M, N),
    }
    emit({"phase": "kernels", "kernel": "sinkhorn", **row})
    if launched != 20 or row["other_records_in_20_calls"]:
        raise AssertionError(f"sinkhorn: 20 wrapper calls ran {launched} Sinkhorn kernels and "
                             f"{row['other_records_in_20_calls']} other device records (one launch a call)")
    if digest != SINKHORN_DIGEST or stale_digest == SINKHORN_DIGEST:
        raise AssertionError(f"sinkhorn: output bits {digest} (stale-u control {stale_digest}), expected "
                             f"{SINKHORN_DIGEST}: the kernel keeps the earlier design's bits")
    return row


# ---------------------------------------------------------------------------
# Phase 3, pose-GN: the kernel against the plain optimizer
# ---------------------------------------------------------------------------

def pose_problem(n, stereo_half, seed=3, outliers=True):
    """``n`` tracks around a true pose (0.5 px noise), a tenth of them gross
    outliers (none without ``outliers``), the last fifteenth invalid; with
    ``stereo_half`` the second half carries stereo rows (bf = 40)."""
    import numpy as np

    from ur_mvo_tpu_torch.utils.synthscene import so3_exp

    rng = np.random.default_rng(seed)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    bf = 40.0
    X = rng.uniform([-2, -2, 4], [2, 2, 9], (n, 3)).astype(np.float32)
    R_true = so3_exp(np.array([0.03, -0.05, 0.02])).astype(np.float32)
    t_true = np.array([0.1, -0.05, 0.03], np.float32)
    pc = X @ R_true.T + t_true
    u = fx * pc[:, 0] / pc[:, 2] + cx + rng.normal(0, 0.5, n)
    v = fy * pc[:, 1] / pc[:, 2] + cy + rng.normal(0, 0.5, n)
    ur = u - bf / pc[:, 2]
    ur[: n // 2 if stereo_half else n] = -1.0
    if outliers:
        u[: n // 10] += rng.uniform(20, 60, n // 10)
    valid = np.ones(n, bool)
    valid[n - n // 15:] = False
    return X, np.stack([u, v, ur], 1).astype(np.float32), valid, R_true, t_true, (fx, fy, cx, cy, bf)


# the fused frame step's two seeds of one problem: the PnP prior's stand-in
# (the identity here) and the last pose
FRAME_STEP_STARTS = (((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)), ((0.01, 0.02, -0.01), (0.05, 0.0, -0.02)))


def pose_skip_mix(seed=11):
    """Two problems of the same tracks, the first with outliers and the
    second without: the second's round 1 repeats its round 0 (nothing to
    drop), the first's does not, so one problem skips rounds while the
    other steps. On the frame step's two seeds and seed 11, the second's
    round 0 runs more steps than the first's round 1 (10 and 8 in the plain
    version on the CPU): a batched skip that let the stepping problem's
    fixed point stop the skipping one would show."""
    return [pose_problem(300, True, seed=seed), pose_problem(300, True, seed=seed, outliers=False)]


def pose_batch(problems, starts, dev="cuda"):
    """(R0, t0, PoseObs, geometry) on ``dev`` of ``pose_problem`` outputs of
    one N and one geometry, each with its start (rotation vector,
    translation)."""
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops.pose_opt import PoseObs
    from ur_mvo_tpu_torch.utils.synthscene import so3_exp

    def stack(arrays):
        return torch.from_numpy(np.stack(arrays)).to(dev)

    R0 = stack([so3_exp(np.array(w, np.float64)).astype(np.float32) for w, _ in starts])
    t0 = stack([np.array(t, np.float32) for _, t in starts])
    obs = PoseObs(X=stack([q[0] for q in problems]), uv=stack([q[1] for q in problems]),
                  valid=stack([q[2] for q in problems]))
    return R0, t0, obs, problems[0][5]


def pose_digest_cases(dev="cuda"):
    """(name, (R0, t0, PoseObs, geometry), schedule keywords) of
    ``pose_gn_digest``: the main path's shape (B = 2, N = 1024 mono, the
    frame step's two seeds; first), 300 tracks with half stereo rows, 1500
    (the streamed route), N = 1 and 257 (ragged), an all-invalid problem,
    one without outliers, 8 problems of different seeds and starts and two
    of which only one repeats its rounds (``pose_skip_mix``), each with the
    whole schedule and cut to 1, 2 and 3 rounds (the outputs of the Huber
    rounds, which the last round's pose does not show), then the schedule
    cut to no step and stretched to 25 steps a round."""
    import numpy as np

    main = pose_batch([pose_problem(1024, False)] * 2, FRAME_STEP_STARTS, dev)
    mixed = pose_batch([pose_problem(300, True)], FRAME_STEP_STARTS[:1], dev)
    X, uv, valid, *rest = pose_problem(300, True, seed=4)
    rng = np.random.default_rng(9)
    starts8 = [(tuple(rng.normal(0, 0.02, 3)), tuple(rng.normal(0, 0.05, 3))) for _ in range(8)]
    problems = [
        ("main B=2 N=1024", main),
        ("N=300 stereo half", mixed),
        ("N=1500 streamed", pose_batch([pose_problem(1500, True)], FRAME_STEP_STARTS[1:], dev)),
        ("N=1", pose_batch([pose_problem(1, False, seed=5)], FRAME_STEP_STARTS[1:], dev)),
        ("N=257", pose_batch([pose_problem(257, True, seed=6)], FRAME_STEP_STARTS[1:], dev)),
        ("all invalid", pose_batch([(X, uv, np.zeros_like(valid), *rest)], FRAME_STEP_STARTS[1:], dev)),
        ("no outliers", pose_batch([pose_problem(600, True, seed=7, outliers=False)], FRAME_STEP_STARTS[:1], dev)),
        ("B=8", pose_batch([pose_problem(512, b % 2 == 1, seed=20 + b) for b in range(8)], starts8, dev)),
        ("B=2 skips differ", pose_batch(pose_skip_mix(), FRAME_STEP_STARTS, dev)),
    ]
    return ([(name, batch, {}) for name, batch in problems]
            + [(f"{name} rounds={r}", batch, {"rounds": r}) for name, batch in problems for r in (1, 2, 3)]
            + [("N=300 stereo half iters=0", mixed, {"iters_per_round": 0}),
               ("main B=2 N=1024 iters=25", main, {"iters_per_round": 25})])


def pose_gn_digest(cases=None):
    """sha256 of the pose-GN kernel's output bits (R, t, inlier flags) on
    ``pose_digest_cases``, with a short digest of each case beside. It calls
    only ``optimize_pose``, which every checkout of the port has, so the same
    function digests an older checkout's kernel."""
    import hashlib

    import torch

    from ur_mvo_tpu_torch.ops.pose_opt import optimize_pose

    digest, parts = hashlib.sha256(), {}
    for name, (R0, t0, obs, geom), kw in cases or pose_digest_cases():
        out = optimize_pose(R0, t0, obs, *geom, **kw)
        b = b"".join(x.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                     for x in (out.R_cw, out.t_cw, out.inliers.to(torch.uint8)))
        digest.update(b)
        parts[name] = hashlib.sha256(b).hexdigest()[:16]
    return digest.hexdigest(), parts


def pose_gn_time(R0, t0, obs, geom):
    """Device ms of the pose-GN kernel a call (profiler) and wall ms of a
    wrapper call, as every checkout's ``optimize_pose`` runs it."""
    from ur_mvo_tpu_torch.ops.pose_opt import optimize_pose

    call = lambda: optimize_pose(R0, t0, obs, *geom)  # noqa: E731
    return {"ms": device_ms(call, ("pose_gn_kernel",))[0], "wall_ms": time_ms(call)}


def pose_gn_phase():
    """The pose-GN kernel against the plain optimizer on the card: 300
    tracks (half stereo rows), 1500 (the streamed route) and the main path's
    batch of two at 1024 mono tracks, R within 2e-5, t within 2e-4, inlier
    flags equal on >= 99%, two launches bit for bit equal, near the true
    pose, while the plain version cut to one round must miss those limits.
    The reference is the plain version's full 4 x 10 schedule, which takes
    neither shortcut; the plain version's shortcut schedule must give its
    bits. The last batch holds two problems of which only one repeats its
    rounds. Then the output bits on ``pose_digest_cases`` against
    ``POSE_GN_DIGEST`` (the kernel of commit f0fbc0f), which a control whose
    round-repeat test ignores the Huber flag must miss, and the steps each
    problem ran per case. Then the times at the main shape beside the plain
    version's, the bound for the steps these inputs ran and the yardstick of
    one step's reduce-and-publish as many times in an empty kernel."""
    import functools

    import torch

    from ur_mvo_tpu_torch.ops import cuda_ext, cuda_pose
    from ur_mvo_tpu_torch.ops.pose_opt import optimize_pose, optimize_pose_plain

    def full_schedule(R0, t0, obs, geom, **kw):
        return optimize_pose_plain(R0, t0, obs.X, obs.uv, obs.valid, *geom, full_schedule=True, **kw)

    TOL_R, TOL_T, MIN_AGREE = 2e-5, 2e-4, 0.99
    worst = 0.0
    # 1500 tracks exceed what the threads hold in registers: the kernel's
    # streaming variant; then the main path's shape; then two problems of
    # which only one repeats its rounds
    for n, stereo_half, problems in ((300, True, [pose_problem(300, True)]), (1500, True, [pose_problem(1500, True)]),
                                     (1024, False, [pose_problem(1024, False)] * 2), (300, True, pose_skip_mix())):
        batch = len(problems)
        _, _, valid, R_true, t_true, _ = problems[0]
        R0, t0, obs, geom = pose_batch(problems, FRAME_STEP_STARTS[:batch])
        out = optimize_pose(R0, t0, obs, *geom)
        again = optimize_pose(R0, t0, obs, *geom)
        ref_R, ref_t, ref_inl, ref_steps = full_schedule(R0, t0, obs, geom)
        short = optimize_pose(R0, t0, obs, *geom, plain=True)  # the shortcut schedule
        cut_R, cut_t, _, _ = full_schedule(R0, t0, obs, geom, rounds=1)  # the negative control
        torch.cuda.synchronize()
        err_R = (out.R_cw - ref_R).abs().max().item()
        err_t = (out.t_cw - ref_t).abs().max().item()
        agree = (out.inliers == ref_inl).float().mean().item()
        cut_R = (cut_R - ref_R).abs().max().item()
        cut_t = (cut_t - ref_t).abs().max().item()
        short_same = bool(torch.equal(short.R_cw, ref_R) and torch.equal(short.t_cw, ref_t)
                          and torch.equal(short.inliers, ref_inl))
        same = bool(torch.equal(out.R_cw, again.R_cw) and torch.equal(out.t_cw, again.t_cw)
                    and torch.equal(out.inliers, again.inliers))
        truth_R = (out.R_cw - torch.from_numpy(R_true).cuda()).abs().max().item()
        truth_t = (out.t_cw - torch.from_numpy(t_true).cuda()).abs().max().item()
        emit({"phase": "kernels", "kernel": "pose_gn", "n": n, "batch": batch, "stereo_rows": stereo_half,
              "err_R": err_R, "tol_R": TOL_R, "err_t": err_t, "tol_t": TOL_T, "inlier_agreement": agree,
              "one_round_err_R": cut_R, "one_round_err_t": cut_t, "repeatable": same,
              "plain_shortcuts_equal_full_schedule": short_same, "full_schedule_steps": ref_steps.tolist(),
              "err_R_vs_truth": truth_R, "err_t_vs_truth": truth_t,
              "n_inliers": out.n_inliers.tolist(), "n_valid": int(valid.sum())})
        if not (err_R <= TOL_R and err_t <= TOL_T and agree >= MIN_AGREE):
            raise AssertionError(f"pose_gn n={n}: kernel vs plain R {err_R} (<= {TOL_R}), t {err_t} (<= {TOL_T}), inliers {agree}")
        if not short_same:
            raise AssertionError(f"pose_gn n={n}: the plain version's shortcut schedule differs from its full schedule")
        if cut_R <= TOL_R and cut_t <= TOL_T:
            raise AssertionError("pose_gn: the limits do not tell a schedule cut to one round from the right result")
        if not same:
            raise AssertionError("pose_gn: two launches on the same inputs differ")
        if not (truth_R < 5e-3 and truth_t < 2e-2):
            raise AssertionError(f"pose_gn n={n}: did not converge to the true pose (R {truth_R}, t {truth_t})")
        worst = max(worst, err_R, err_t)

    # the output bits, the Huber-blind control's and the steps run per case
    cases = pose_digest_cases()
    wrapper, run_steps = cuda_pose.pose_gn, []

    def recording(*args, **kw):
        out = wrapper(*args, **kw)
        run_steps.append(out[3].tolist())
        return out

    try:
        cuda_pose.pose_gn = recording
        digest, parts = pose_gn_digest(cases)
        cuda_pose.pose_gn = functools.partial(wrapper, huber_blind=True)
        blind_digest, blind_parts = pose_gn_digest(cases)
    finally:
        cuda_pose.pose_gn = wrapper
    steps = dict(zip(parts, run_steps))
    emit({"phase": "kernels", "kernel": "pose_gn", "digest": digest, "expected": POSE_GN_DIGEST,
          "huber_blind_digest": blind_digest, "digest_parts": parts,
          "huber_blind_differs_in": [k for k in parts if parts[k] != blind_parts[k]], "steps_run": steps})

    # times at the main path's shape: B = 2 seeds, N = 1024 mono tracks
    R0, t0, obs, geom = cases[0][1]
    B, N = obs.X.shape[:2]
    main = cases[0][0]
    run = steps[main]
    # the rounds each problem ran: round 0, and each later round whose cut
    # adds steps (a skipped round adds none)
    by_rounds = [steps[f"{main} rounds={r}"] for r in (1, 2, 3)] + [run]
    rounds_run = [1 + sum(later[b] > earlier[b] for earlier, later in zip(by_rounds, by_rounds[1:]))
                  for b in range(B)]
    ext = cuda_ext.extension()
    nbytes = B * (N * (12 + 12 + 1) + 36 + 12) + B * (48 + N + 4)
    # per point and pass: one projection (~30), weights (~6), three
    # Jacobian rows (~40), 21 + 6 weighted sums (~190), two costs (~12); a
    # pass for each step and one at T0 for each round that runs, each pass
    # followed by 29 block-wide sums over 256 partials; per point and round
    # that runs a reclassification (a projection and two tests, ~35). For
    # the steps and rounds each problem of these inputs runs, as the
    # kernel reports them
    ops = sum(N * ((s + r) * 278.0 + r * 35.0) + (s + r) * 29 * 255.0 for s, r in zip(run, rounds_run))
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_F32)
    row = {
        "max_abs_err": worst, "steps_run": run, "rounds_run": rounds_run,
        **timings(lambda: optimize_pose(R0, t0, obs, *geom), ("pose_gn_kernel",),
                  lambda: optimize_pose(R0, t0, obs, *geom, plain=True), plain_calls=3),
        "before_ms": POSE_GN_BEFORE[0], "before_wall_ms": POSE_GN_BEFORE[1],
        "bound_ms": b_ms, "bound_by": b_by,
        # one step's reduce-and-publish, as many times as the slower problem
        # ran steps, in an empty kernel of the same shape
        "chain_ms": device_ms(lambda: ext.pose_gn_chain(obs.X, B, max(run)), ("chain_kernel",))[0],
        "single_problem_ms": device_ms(lambda: optimize_pose(R0[0], t0[0], type(obs)(*(f[0] for f in obs)), *geom),
                                       ("pose_gn_kernel",))[0],
    }
    emit({"phase": "kernels", "kernel": "pose_gn", "shape": f"B={B} N={N}", **row})
    if digest != POSE_GN_DIGEST or blind_digest == POSE_GN_DIGEST:
        raise AssertionError(f"pose_gn: output bits {digest} (Huber-blind control {blind_digest}), expected "
                             f"{POSE_GN_DIGEST}: the kernel keeps the earlier design's bits")
    return row


# ---------------------------------------------------------------------------
# Phase 9: the two BA point-reduce kernels against their plain versions
# ---------------------------------------------------------------------------

def point_reduce_problem(P, O, FF, seed, dev):
    """Value rows of a BA point side: every point observed by 2..2(O/P)-2
    rows from distinct free slots, the rest of the O rows padding (zero
    values on point 0, as BA pads). Returns the rows in a shuffled order
    (the unsorted kernel's input) and, as ``ops.ba.make_sorted_layout``
    lays them out, the point-sorted rows with the padding last, their
    slots and the CSR over points (the sorted kernel's)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    per = np.minimum(rng.integers(2, max(3, 2 * O // P - 1), P), FF)
    while per.sum() > O:
        per = np.maximum(per - 1, 1)
    pt = np.repeat(np.arange(P), per)
    slot = np.concatenate([rng.permutation(FF)[:k] for k in per])
    n = len(pt)
    A = np.zeros((O, 18), np.float32)
    Vp = np.zeros((O, 12), np.float32)
    A[:n] = rng.normal(size=(n, 18))
    Vp[:n] = rng.normal(size=(n, 12))
    pt = np.concatenate([pt, np.zeros(O - n, np.int64)])
    slot = np.concatenate([slot, np.zeros(O - n, np.int64)])
    shuffle = rng.permutation(O)
    key = np.where(np.arange(O) < n, pt, P)[shuffle]
    order = np.argsort(key, kind="stable")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    seg = np.searchsorted(key[order], np.arange(P + 1))
    unsorted = tuple(t(a[shuffle]) for a in (A, Vp, pt, slot))
    sorted_ = tuple(t(a[shuffle][order]) for a in (A, Vp, pt, slot)) + (t(seg),)
    return unsorted, sorted_, n


def ba_kernels_phase(smi, shapes=None):
    """Both kernels against their plain versions at each shape (P, O, FF):
    max |err| <= 1e-5 of max |plain| (float32 summation order), the sorted
    kernel bit for bit equal over two launches, and two wrong inputs (one
    row's slot id off by one; one row given to the neighbouring point, a
    rank off by one) that must miss that limit. Returns the last shape's
    rows (the global BA's, where ``global_ba`` launches them) with the
    largest error over all shapes."""
    import torch

    from ur_mvo_tpu_torch.ops import cuda_ba

    dev = torch.device("cuda")
    rows = None
    worst = {"point_reduce_sorted": 0.0, "point_reduce": 0.0}
    for P, O, FF in shapes or BA_KERNEL_SHAPES:
        (A, Vp, pt, slot), (As, Vps, pts, slots, seg), n = point_reduce_problem(P, O, FF, seed=P + O, dev=dev)
        ref = cuda_ba.point_reduce_plain(A, Vp, pt, slot, P, FF)
        tol = 1e-5 * ref.abs().max().item()
        out_s = cuda_ba.point_reduce_sorted(As, Vps, pts, slots, seg, FF)
        again = cuda_ba.point_reduce_sorted(As, Vps, pts, slots, seg, FF)
        out_u = cuda_ba.point_reduce(A, Vp, pt, slot, P, FF)
        # the controls: a real row's slot id off by one; the first row of
        # point 1 handed to point 0 (its rank off by one)
        bad_slot = slots.clone()
        real = int(seg[1])  # the first row of point 1
        bad_slot[real] = (bad_slot[real] + 1) % FF
        bad_pt, bad_seg = pts.clone(), seg.clone()
        bad_pt[real] = 0
        bad_seg[1] += 1
        ctl_slot = cuda_ba.point_reduce_sorted(As, Vps, pts, bad_slot, seg, FF)
        ctl_rank = cuda_ba.point_reduce_sorted(As, Vps, bad_pt, slots, bad_seg, FF)
        torch.cuda.synchronize()
        err_s = (out_s - ref).abs().max().item()
        err_u = (out_u - ref).abs().max().item()
        row = {
            "shape": {"P": P, "O": O, "FF": FF, "real_rows": n}, "tol": tol,
            "sorted_err": err_s, "unsorted_err": err_u, "sorted_bitwise_repeatable": bool(torch.equal(out_s, again)),
            "control_slot_off_by_one_err": (ctl_slot - ref).abs().max().item(),
            "control_rank_off_by_one_err": (ctl_rank - ref).abs().max().item(),
            "empty_points_exact_zero": bool((out_s[torch.diff(seg) == 0] == 0).all()),
        }
        # the function needs the n real rows (padding rows are zero and
        # add nothing) read once and the output written once
        V = FF * 18 + 12
        out_bytes = 4.0 * P * V
        in_bytes = 4.0 * n * 30
        b_s = bound_ms(in_bytes + 4.0 * n + 4.0 * (P + 1) + out_bytes, 30.0 * n, PEAK_F32)
        b_u = bound_ms(in_bytes + 8.0 * n + out_bytes, 30.0 * n, PEAK_F32)
        # the yardstick: ONE index_add_ of the bf16-rounded summands into
        # the flat (P * V) output (after its zero fill)
        cols = torch.cat([slot.clamp(0, FF - 1)[:, None] * 18 + torch.arange(18, device=dev),
                          FF * 18 + torch.arange(12, device=dev).expand(O, 12)], 1)
        flat = (pt[:, None] * V + cols).reshape(-1)
        vals = torch.cat([A, Vp], 1).to(torch.bfloat16).float().reshape(-1)

        def library():
            return torch.zeros(P * V, device=dev).index_add_(0, flat, vals)

        row["point_reduce_sorted"] = {
            **timings(lambda: cuda_ba.point_reduce_sorted(As, Vps, pts, slots, seg, FF), ("point_reduce_sorted",),
                      lambda: cuda_ba.point_reduce_plain(As, Vps, pts, slots, P, FF), library, cold_l2=True),
            "bound_ms": b_s[0], "bound_by": b_s[1], "max_abs_err": err_s,
        }
        row["point_reduce"] = {
            **timings(lambda: cuda_ba.point_reduce(A, Vp, pt, slot, P, FF), ("point_reduce_atomic", "Memset"),
                      lambda: cuda_ba.point_reduce_plain(A, Vp, pt, slot, P, FF), library, cold_l2=True),
            "bound_ms": b_u[0], "bound_by": b_u[1], "max_abs_err": err_u,
        }
        emit({"phase": "ba_kernels", **row, "card": smi})
        where = f"ba_kernels P={P} O={O} FF={FF}"
        if not (err_s <= tol and err_u <= tol):
            raise AssertionError(f"{where}: kernel vs plain sorted {err_s}, unsorted {err_u} (<= {tol})")
        if not row["sorted_bitwise_repeatable"]:
            raise AssertionError(f"{where}: two launches of the sorted kernel differ")
        if not row["empty_points_exact_zero"]:
            raise AssertionError(f"{where}: a point without observations has a non-zero row")
        if not min(row["control_slot_off_by_one_err"], row["control_rank_off_by_one_err"]) > tol:
            raise AssertionError(f"{where}: the limit does not tell a wrong slot or rank from the right sums")
        rows = {k: row[k] for k in worst}
        worst = {k: max(v, row[k]["max_abs_err"]) for k, v in worst.items()}
    return {k: dict(rows[k], max_abs_err=worst[k]) for k in worst}


# ---------------------------------------------------------------------------
# Phase 10: the long protocol (relocalization, loop closure, global BA)
# ---------------------------------------------------------------------------

def long_map(n_points, per_kf, seed=31):
    """A map store as a long monocular run leaves it before global
    optimization, past the 128M-element line: keyframes at frames 0, 2, 5,
    8, ..., 119 of the long protocol's out-and-back path (640x480, fx 520;
    frames 0 and 2 are the full BA's gauge), ``n_points`` scene points 3-7 m
    ahead, each keyframe observing ``per_kf`` of those in its view, drawn at
    random (0.5 px noise, 1% gross outliers). The estimate drifts as mono
    VO does: each step 0.5% a keyframe longer than the last and turned by a
    growing heading error, every point placed by its first observer's
    drifted pose (2 cm noise). One loop edge, the revisit of the start: the
    first keyframe against the last, relative pose and inter-leg scale
    measured from the truth. Returns the store, its keyframe slots in frame
    order and their true positions."""
    import numpy as np

    from ur_mvo_tpu_torch.runtime.map_store import MapStore, StoreConfig
    from ur_mvo_tpu_torch.utils.synthscene import out_and_back_trajectory, so3_exp

    rng = np.random.default_rng(seed)
    K = 1024
    frames = [0] + list(range(2, LONG_FRAMES, 3))
    T = out_and_back_trajectory(LONG_FRAMES)[frames]
    R_true, t_true = T[:, :3, :3], T[:, :3, 3]
    n = len(frames)
    drift = 1.0 + 0.005 * np.arange(n)
    R_est = np.stack([so3_exp(np.array([0.0, 0.002 * k, 0.001 * k])) @ R_true[k] for k in range(n)])
    t_est = t_true.copy()
    for k in range(1, n):
        step = so3_exp(np.array([0.0, 0.002 * k, 0.0])) @ (t_true[k] - t_true[k - 1])
        t_est[k] = t_est[k - 1] + drift[k] * step
    X = np.stack([rng.uniform(-2.5, 5.5, n_points), rng.uniform(-1.8, 1.8, n_points), rng.uniform(3, 7, n_points)], 1)
    st = MapStore(StoreConfig(max_keyframes=64, max_mappoints=n_points, keypoints_per_frame=K, store_descriptors=False))
    mp = st.alloc_mappoints(n_points)
    st.mp_good[mp] = True
    first = np.full(n_points, -1)
    slots = []
    for k in range(n):
        pc = (X - t_true[k]) @ R_true[k]
        u, v = LONG_FX * pc[:, 0] / pc[:, 2] + LONG_W / 2, LONG_FX * pc[:, 1] / pc[:, 2] + LONG_H / 2
        seen = np.nonzero((pc[:, 2] > 0.5) & (u > 0) & (u < LONG_W) & (v > 0) & (v < LONG_H))[0]
        ids = np.sort(rng.choice(seen, min(per_kf, len(seen)), replace=False))
        kpts = np.zeros((K, 3), np.float32)
        uv = np.stack([u[ids], v[ids]], 1) + rng.normal(0, 0.5, (len(ids), 2))
        uv[rng.random(len(ids)) < 0.01] += 40.0
        kpts[: len(ids)] = np.concatenate([uv, -np.ones((len(ids), 1))], 1)
        s = st.alloc_keyframe(frames[k], frames[k] / FPS, R_est[k].astype(np.float32), t_est[k].astype(np.float32),
                              kpts, np.arange(K) < len(ids))
        st.add_observations(s, mp[ids], np.arange(len(ids)))
        first[ids[first[ids] < 0]] = k
        slots.append(s)
    seen = first >= 0
    ref = first[seen]
    # X_est = T_est(ref) T_true(ref)^-1 X
    Xc = np.einsum("nji,nj->ni", R_true[ref], X[seen] - t_true[ref])
    st.mp_pos[mp[seen]] = (np.einsum("nij,nj->ni", R_est[ref], Xc) + t_est[ref]
                           + rng.normal(0, 0.02, Xc.shape)).astype(np.float32)
    R_ij = (R_true[0].T @ R_true[-1]).astype(np.float32)
    t_ij = (R_true[0].T @ (t_true[-1] - t_true[0])).astype(np.float32)
    st.loop_edges.append((slots[0], slots[-1], R_ij, t_ij, 3.0, 1.0 / drift[-1]))
    return st, np.asarray(slots), t_true


def long_map_global_optimize(smi, template):
    """``Backend.global_optimize()`` on :func:`long_map`'s store
    (``LONG_MAP``), in a backend configured as ``template`` (the long
    engine's), launch counts reset just before: its full BA must resolve
    ``"auto"`` to ``"sorted"`` and launch the sorted kernel. The same call
    with ``kernels=False`` on a copy of the store: keyframes and points
    within phase 7's limits (R 1e-3, t 1e-3, X 5e-3) of it; the keyframe
    ATE after it below the one before. Returns the kernel run's launches."""
    import copy

    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops import cuda_ext
    from ur_mvo_tpu_torch.runtime.backend import Backend
    from ur_mvo_tpu_torch.utils.metrics import ate_rmse

    st, order, t_true = long_map(*LONG_MAP)

    def ate(store):
        return float(ate_rmse(store.kf_t[order], t_true, align=True, correct_scale=True))

    row = {"phase": "long_map", "keyframes": len(order), "ate_before": ate(st)}
    stores, launches = {}, {}
    for name, kernels in (("kernels", True), ("plain", False)):
        b = Backend(template.camera, template.cfg, template.opt_cfg, store=copy.deepcopy(st),
                    keypoints_per_frame=st.cfg.keypoints_per_frame, device="cuda", kernels=kernels)
        torch.cuda.synchronize()
        cuda_ext.LAUNCHES.clear()
        t0 = time.perf_counter()
        b.global_optimize()
        torch.cuda.synchronize()
        launches[name] = dict(cuda_ext.LAUNCHES)
        stores[name] = b.store
        row[name] = {"seconds": time.perf_counter() - t0, "ate_after": ate(b.store), "full_ba": b.last_full_ba,
                     "parts_s": {k: v["total_s"] for k, v in b.timer.summary().items()}, "launches": launches[name]}
    k, p = stores["kernels"], stores["plain"]
    used = np.nonzero(st.mp_obs_count >= 2)[0]
    diff = {"R": float(np.abs(k.kf_R[order] - p.kf_R[order]).max()),
            "t": float(np.abs(k.kf_t[order] - p.kf_t[order]).max()),
            "X": float(np.abs(k.mp_pos[used] - p.mp_pos[used]).max())}
    row["kernels_vs_plain"] = {**diff, "bitwise_equal": bool(np.array_equal(k.kf_t, p.kf_t)
                                                            and np.array_equal(k.mp_pos, p.mp_pos))}
    emit({**row, "card": smi})
    full = row["kernels"]["full_ba"]
    if full is None or full["assembly"] != "sorted" or launches["kernels"].get("point_reduce_sorted", 0) == 0:
        raise AssertionError(f"long_map: the full BA {full} did not run the sorted kernel: {launches['kernels']}")
    if launches["plain"]:
        raise AssertionError(f"long_map: kernels=False launched kernels: {launches['plain']}")
    if not (diff["R"] <= 1e-3 and diff["t"] <= 1e-3 and diff["X"] <= 5e-3):
        raise AssertionError(f"long_map: kernels vs plain {diff} (R 1e-3, t 1e-3, X 5e-3)")
    if not row["kernels"]["ate_after"] < row["ate_before"]:
        raise AssertionError(f"long_map: keyframe ATE {row['ate_before']} -> {row['kernels']['ate_after']}")
    return launches["kernels"], tuple(full["padded"])


def long_scene(seed):
    """The long protocol's frames and true poses for one scene seed."""
    from ur_mvo_tpu_torch.components import Frame, Image
    from ur_mvo_tpu_torch.utils.synthscene import out_and_back_trajectory, render_sequence

    images, T_wc, _ = render_sequence(LONG_FRAMES, LONG_H, LONG_W, LONG_FX, seed=seed, n_planes=3,
                                      z_background=6.0, poses=out_and_back_trajectory(LONG_FRAMES))
    return [Frame(image=Image(images[i], i / FPS)) for i in range(LONG_FRAMES)], T_wc


def long_run(vo, seed, scene):
    """One long-protocol run: the online ATE of the emitted trajectory, then
    ``global_optimize()`` and the ATE of the keyframe trajectory after it."""
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.utils.metrics import ate_rmse

    frames, T_wc = scene
    backend = vo.tracker.backend
    vo.reset()
    vo.tracker.timer.reset()
    t0 = time.perf_counter()
    per_frame, stamps, poses, init_at = run_engine(vo, frames)
    online_s = time.perf_counter() - t0
    online = emitted_ate(stamps, poses, T_wc)
    st = backend.store
    row = {"seed": seed, "initialised_at_frame": init_at, "keyframes": st.num_keyframes(),
           "loop_edges": len(st.loop_edges), "relocalizations": vo.tracker.relocalizations,
           "frames_lost": vo.tracker.frames_lost, "poses_emitted": len(poses), "online_ate": online,
           "online_seconds": online_s,
           "stages": {k: {"count": v["count"], "mean_ms": v["mean_ms"]} for k, v in vo.tracker.timer.summary().items()}}
    backend.timer.reset()
    backend.last_full_ba = None
    t0 = time.perf_counter()
    backend.global_optimize()
    torch.cuda.synchronize()
    row["global_optimize_seconds"] = time.perf_counter() - t0
    row["global_optimize_parts_s"] = {k: v["total_s"] for k, v in backend.timer.summary().items()}
    row["full_ba"] = backend.last_full_ba
    kts, kpos, _ = vo.keyframe_trajectory()
    kidx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, LONG_FRAMES - 1)
    row["pgo_ate"] = float(ate_rmse(np.asarray(kpos), T_wc[kidx][:, :3, 3], align=True, correct_scale=True))
    return row


def route_attention(how):
    """Points the matcher's attention at one bf16 route for a long sweep:
    ``"kernel"`` the main path's kernel (as it is), ``"split"`` the key-group
    kernel, ``"plain"`` the plain version, every other kernel on."""
    import functools

    from ur_mvo_tpu_torch.models import superglue
    from ur_mvo_tpu_torch.ops import cuda_kernels

    superglue.attention = {
        "kernel": cuda_kernels.attention,
        "split": functools.partial(cuda_kernels.attention, split=True),
        "plain": lambda q, k, v, kv_valid, plain=False: cuda_kernels.attention_plain(q, k, v, kv_valid),
    }[how]


def audit_attention(records):
    """Wraps the matcher's attention as routed: each call also runs the plain
    version and both bf16 kernels on the same inputs and appends to
    ``records`` the call's layer (0-17), bank sizes and valid counts, the
    largest valid logit, and per kernel its largest error over the phase-3
    bound (2^-6 max |plain|), the share of its outputs whose bits differ
    from the plain version's and its mean signed error over mean |plain|;
    and whether two launches of the key-group kernel agree bit for bit."""
    import math

    import torch

    from ur_mvo_tpu_torch.models import superglue
    from ur_mvo_tpu_torch.ops import cuda_kernels

    routed = superglue.attention

    def audited(q, k, v, kv_valid, plain=False):
        out = routed(q, k, v, kv_valid, plain=plain)
        ref = cuda_kernels.attention_plain(q, k, v, kv_valid).float()
        split = cuda_kernels.attention(q, k, v, kv_valid, split=True)
        scale = ref.abs()
        stats = [scale.max(), (split != cuda_kernels.attention(q, k, v, kv_valid, split=True)).any()]
        for o in (cuda_kernels.attention(q, k, v, kv_valid), split):
            diff = o.float() - ref
            stats += [diff.abs().max(), (diff != 0).float().mean(), diff.mean() / scale.mean()]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
        stats.append(logits.masked_fill(~kv_valid[:, None, None, :], -math.inf).amax())
        vals = torch.stack([x.float() for x in stats]).tolist()
        tol = 2.0**-6 * vals[0]
        records.append({
            "layer": len(records) % 18, "Kq": q.shape[1], "Kkv": k.shape[1], "valid": kv_valid.sum(1).tolist(),
            "split_repeat_differs": bool(vals[1]), "logit_max": vals[-1],
            "kernel": [vals[2] / tol, vals[3], vals[4]], "split": [vals[5] / tol, vals[6], vals[7]],
        })
        return out

    superglue.attention = audited


def summarize_audit(records, seed):
    """One line per layer of ``audit_attention``'s records of a run."""
    for layer in range(18):
        rs = [r for r in records if r["layer"] == layer]
        if not rs:
            continue
        row = {"phase": "attention_audit", "seed": seed, "layer": layer, "calls": len(rs),
               "shapes": sorted({(r["Kq"], r["Kkv"]) for r in rs}),
               "min_valid": min(min(r["valid"]) for r in rs),
               "calls_with_an_empty_bank": sum(min(r["valid"]) == 0 for r in rs),
               "logit_max": max(r["logit_max"] for r in rs),
               "split_repeat_differs": sum(r["split_repeat_differs"] for r in rs)}
        for name in ("kernel", "split"):
            row[name] = {"max_err_over_tol": max(r[name][0] for r in rs),
                         "mean_share_off": statistics.mean(r[name][1] for r in rs),
                         "mean_bias": statistics.mean(r[name][2] for r in rs),
                         "max_abs_bias": max(abs(r[name][2]) for r in rs)}
        emit(row)


def long_sweep(seeds, plain=False, attention="kernel", audit=False):
    """The long protocol on more scene seeds than the gate's three, under
    deterministic algorithms, on the kernels (or, ``plain``, every kernel's
    plain version): the spread of its online and after-global_optimize ATE
    from seed to seed, which a gate on a 3-seed mean has to stand.
    ``attention`` routes the matcher's attention (:func:`route_attention`);
    ``audit`` also holds both bf16 kernels against the plain version on every
    attention call of the run (:func:`audit_attention`)."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    vo = production_engine(kernels=not plain, long_run=True)
    route_attention(attention)
    records = []
    if audit:
        audit_attention(records)
    for seed in seeds:
        records.clear()
        row = long_run(vo, seed, long_scene(seed))
        emit({"phase": "long_sweep", "path": "plain" if plain else "kernels", "attention": attention,
              **{k: row[k] for k in ("seed", "online_ate", "pgo_ate", "frames_lost", "loop_edges", "keyframes")}})
        if audit:
            summarize_audit(records, seed)
    route_attention("kernel")
    vo.shutdown()


def long_phase(smi):
    """``scripts/bench_accuracy.py --long`` for ``mono/long`` with matcher
    ``sg``: per seed the online ATE of the emitted trajectory, then
    ``global_optimize()`` and the ATE of the final keyframe trajectory,
    under PyTorch's deterministic algorithms. Every kernel of the path must
    launch. The full BA's size and resolved assembly are reported: on this
    protocol culling keeps the map far under the 128M-element line (~500
    points), so its full BA takes the float32 ``index_add_`` route; the
    phase says so and then runs ``global_optimize`` on a long map past
    the line (:func:`long_map_global_optimize`), which must launch the
    sorted kernel. Returns the launch counts (the sorted kernel's from that
    map) and that full BA's shape (P, O, FF)."""
    import torch

    from ur_mvo_tpu_torch.ops import cuda_ext

    torch.use_deterministic_algorithms(True, warn_only=True)
    scenes = {seed: long_scene(seed) for seed in ENGINE_SEEDS}
    vo = production_engine(long_run=True)
    backend = vo.tracker.backend

    # --- the main path, with launch counts -------------------------------
    cuda_ext.LAUNCHES.clear()
    rows = []
    for seed in ENGINE_SEEDS:
        row = long_run(vo, seed, scenes[seed])
        rows.append(row)
        emit({"phase": "long", **row})
    launches = dict(cuda_ext.LAUNCHES)
    torch.use_deterministic_algorithms(False)
    failed = [r["seed"] for r in rows if r["online_ate"] is None]
    online = statistics.mean(r["online_ate"] for r in rows if r["online_ate"] is not None) if len(failed) < len(rows) else None
    pgo = statistics.mean(r["pgo_ate"] for r in rows)
    emit({"phase": "long_summary", "seeds": list(ENGINE_SEEDS), "frames": LONG_FRAMES, "size": [LONG_H, LONG_W],
          "online_mean_ate": online, "pgo_mean_ate": pgo, "failed_seeds": failed,
          "gate": {"online": LONG_MAX_ONLINE, "pgo": LONG_MAX_PGO}, "launches": launches, "card": smi})
    if failed:
        raise AssertionError(f"long: seeds {failed} emitted fewer than 5 poses (failed runs)")
    if not (online < LONG_MAX_ONLINE and pgo < LONG_MAX_PGO and pgo < online):
        raise AssertionError(f"long: online mean ATE {online} (< {LONG_MAX_ONLINE}), after global optimization "
                             f"{pgo} (< {LONG_MAX_PGO} and < online)")
    missing = [k for k in ENGINE_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"long: kernels of the path never launched: {missing}")
    if any(r["full_ba"] is None for r in rows):
        raise AssertionError("long: a seed's global_optimize ran no full BA")
    crossed = [r["seed"] for r in rows if r["full_ba"]["assembly"] == "sorted"]
    if not crossed:
        emit({"phase": "long", "note": "no seed's map crossed the 128M-element line: its full BA took index_add_; "
              "the sorted kernel must launch in global_optimize on the long map",
              "full_ba_padded": [r["full_ba"]["padded"] for r in rows]})
    torch.use_deterministic_algorithms(True, warn_only=True)
    map_launches, (F, P, O) = long_map_global_optimize(smi, backend)
    vo.shutdown()
    launches["point_reduce_sorted"] = launches.get("point_reduce_sorted", 0) + map_launches.get("point_reduce_sorted", 0)
    return launches, (P, O, F)


# ---------------------------------------------------------------------------
# Phase 12: a global BA through bundle_adjust's "auto"
# ---------------------------------------------------------------------------

def global_ba_problem(P, per, F, seed=21):
    """P points 6-12 m ahead of F keyframes ``SPACING`` apart along a
    gently turning path, each point observed by ``per`` of the keyframes
    that see it, drawn at random (0.5 px noise, 1% gross outliers): a
    keyframe shares points with every keyframe whose view overlaps its own.
    The first two and the last two keyframes fixed at the truth (a loop has
    closed: with the far end free the chain bends at little cost, and the
    solve amplifies summation-order differences along that mode), the rest
    and the points perturbed. Returns the problem's fields (numpy), the
    truth and the camera."""
    import numpy as np

    from ur_mvo_tpu_torch.utils.synthscene import so3_exp

    rng = np.random.default_rng(seed)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    R_true = np.stack([so3_exp(np.array([0.01 * np.sin(0.2 * f), 0.1 * np.sin(0.05 * f), 0.0])) for f in range(F)])
    t_true = np.stack([[SPACING * f, 0.3 * np.sin(0.1 * f), 0.0] for f in range(F)])
    X = np.stack([rng.uniform(-1.0, SPACING * F + 1.0, P), rng.uniform(-1.5, 1.5, P), rng.uniform(6, 12, P)], 1)
    # each point's observers: `per` of the keyframes that see it, at random
    pc_all = np.einsum("fji,pfj->pfi", R_true, X[:, None, :] - t_true[None])
    u_all = fx * pc_all[..., 0] / pc_all[..., 2] + cx
    v_all = fy * pc_all[..., 1] / pc_all[..., 2] + cy
    seen = (pc_all[..., 2] > 1.0) & (u_all > 0) & (u_all < 2 * cx) & (v_all > 0) & (v_all < 2 * cy)
    obs_p = np.repeat(np.arange(P), per)
    obs_f = np.argsort(np.where(seen, rng.random((P, F)), 2.0), axis=1)[:, :per].reshape(-1)
    pc = pc_all[obs_p, obs_f]
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], 1) + rng.normal(0, 0.5, (len(obs_p), 2))
    out = rng.random(len(obs_p)) < 0.01
    uv[out] += 40.0
    R0 = np.einsum("fij,fjk->fik", np.stack([so3_exp(0.01 * rng.normal(size=3)) for _ in range(F)]), R_true)
    t0 = t_true + 0.03 * rng.normal(size=t_true.shape)
    fixed = (np.arange(F) < 2) | (np.arange(F) >= F - 2)
    R0[fixed], t0[fixed] = R_true[fixed], t_true[fixed]
    f32 = np.float32
    fields = (R0.astype(f32), t0.astype(f32), np.ones(F, bool), fixed,
              (X + 0.05 * rng.normal(size=X.shape)).astype(f32), np.ones(P, bool), obs_f.astype(np.int64),
              obs_p.astype(np.int64), np.concatenate([uv, -np.ones((len(uv), 1))], 1).astype(f32),
              np.ones(len(obs_p), bool))
    return fields, (R_true, t_true, X), (fx, fy, cx, cy, 0.0)


def global_ba_phase(smi):
    """``bundle_adjust`` on a global BA (``GLOBAL_BA``: 65,536 points and
    524,288 observations over 48 keyframes, both ends fixed): ``"auto"``
    must resolve to ``"sorted"`` and launch the sorted kernel, and its
    solution must agree with the plain assembly's on the card (R 1e-3, t
    1e-3, X 5e-3 at the worst point, inlier verdicts on >= 99%, the limits
    of phase 7) and reach the truth (t within 5e-2 as in phase 7, R within
    5e-3). Under PyTorch's deterministic algorithms the plain assembly's
    ``index_add_`` sums each point's rows in row order, as the sorted
    kernel does. Then the explicit ``assembly="pallas"`` (the unsorted
    kernel), whose atomics leave the summation order to the scheduler: the
    LM's accept test at convergence turns last-bit differences into moves
    of the weakest points, so its worst point is held to ``PALLAS_X`` (R,
    t and the verdicts to phase 7's limits). Two readings frame that
    limit: the plain assembly on the observations in a shuffled order (the
    same kind of difference, which must pass it) and the unsorted kernel
    given every row's frame slot off by one (a wrong assembly, which must
    miss it). At the production gauge, with only the first keyframes fixed
    (``Backend._full_bundle_adjustment``; phase 9's long map), the atomic
    route does not repeat at all: the chain's bending mode amplifies the
    summation order. Returns the unsorted kernel's launches."""
    import torch

    from ur_mvo_tpu_torch.ops import cuda_ba, cuda_ext
    from ur_mvo_tpu_torch.ops.ba import BAConfig, bundle_adjust, permute_observations, resolve_assembly
    from ur_mvo_tpu_torch.weights import ba_problem_from_numpy

    P, per, F = GLOBAL_BA
    fields, (R_true, t_true, _), geom = global_ba_problem(P, per, F)
    prob = ba_problem_from_numpy(fields, "cuda")
    perm = torch.randperm(P * per, generator=torch.Generator().manual_seed(5)).to("cuda")
    # the fixed 10+5 schedule (tol 0): with the early exit, a last-bit
    # difference in the cost can end the two runs at different iterations
    cfg = BAConfig(max_free_frames=F, tol=0.0)
    pallas = cfg._replace(assembly="pallas")
    assembly = resolve_assembly(cfg, n_obs=P * per, n_points=P)
    point_reduce = cuda_ba.point_reduce

    def slot_off_by_one(A, Vp, pt, slot, P, FF, plain=False):
        return point_reduce(A, Vp, pt, (slot + 1) % FF, P, FF, plain=plain)

    runs, launches = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    with torch.no_grad():
        bundle_adjust(prob, *geom, cfg, plain=True)  # warm-up: the solver libraries' first calls
        for name, c, plain, p in (("plain", cfg, True, prob), ("auto", cfg, False, prob),
                                  ("pallas", pallas, False, prob),
                                  ("plain_shuffled", cfg, True, permute_observations(prob, perm)),
                                  ("control_slot_off_by_one", pallas, False, prob)):
            cuda_ba.point_reduce = slot_off_by_one if name.startswith("control") else point_reduce
            try:
                cuda_ext.LAUNCHES.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[name] = bundle_adjust(p, *geom, c, plain=plain)
                torch.cuda.synchronize()
            finally:
                cuda_ba.point_reduce = point_reduce
            launches[name] = dict(cuda_ext.LAUNCHES)
            launches[name]["host_ms"] = 1e3 * (time.perf_counter() - t0)
    torch.use_deterministic_algorithms(False)
    shuffled = runs["plain_shuffled"]
    runs["plain_shuffled"] = shuffled._replace(obs_inlier=torch.empty_like(shuffled.obs_inlier).index_put_(
        (perm,), shuffled.obs_inlier))
    ref = runs["plain"]
    row = {"phase": "global_ba", "points": P, "observations": P * per, "keyframes": F, "assembly": assembly,
           "pallas_x_limit": PALLAS_X}
    for name in ("auto", "pallas", "plain_shuffled", "control_slot_off_by_one"):
        r = runs[name]
        dX = (r.X - ref.X).abs().amax(1)
        row[name] = {
            "R": (r.R_wc - ref.R_wc).abs().max().item(), "t": (r.t_wc - ref.t_wc).abs().max().item(),
            "X": dX.max().item(), "X_q999": torch.quantile(dX, 0.999).item(),
            "bitwise_equal": bool(torch.equal(r.X, ref.X) and torch.equal(r.t_wc, ref.t_wc)),
            "inlier_agreement": (r.obs_inlier == ref.obs_inlier).float().mean().item(),
            "launches": launches[name],
            "err_t_vs_truth": (r.t_wc.cpu() - torch.from_numpy(t_true).float()).abs().max().item(),
            "err_R_vs_truth": (r.R_wc.cpu() - torch.from_numpy(R_true).float()).abs().max().item(),
        }
    row["plain_host_ms"] = launches["plain"]["host_ms"]
    row["inliers"] = int(runs["auto"].obs_inlier.sum().item())
    emit({**row, "card": smi})
    if assembly != "sorted" or launches["auto"].get("point_reduce_sorted", 0) == 0:
        raise AssertionError(f"global_ba: \"auto\" resolved to {assembly!r}, launches {launches['auto']}")
    if launches["plain"].get("point_reduce_sorted", 0) or launches["pallas"].get("point_reduce", 0) == 0:
        raise AssertionError(f"global_ba: launches plain {launches['plain']}, pallas {launches['pallas']}")

    def within(d, x_limit):
        return d["R"] <= 1e-3 and d["t"] <= 1e-3 and d["X"] <= x_limit and d["inlier_agreement"] >= 0.99

    for name, x_limit in (("auto", 5e-3), ("pallas", PALLAS_X), ("plain_shuffled", PALLAS_X)):
        d = row[name]
        if not within(d, x_limit):
            raise AssertionError(f"global_ba {name} vs plain assembly (X {x_limit}): {d}")
        if not (d["err_t_vs_truth"] < 5e-2 and d["err_R_vs_truth"] < 5e-3):
            raise AssertionError(f"global_ba {name}: did not converge to the truth: {d}")
    if within(row["control_slot_off_by_one"], PALLAS_X):
        raise AssertionError(f"global_ba: a wrong assembly passes the pallas limits: {row['control_slot_off_by_one']}")
    return {"point_reduce": launches["pallas"].get("point_reduce", 0)}


# ---------------------------------------------------------------------------
# Phases 4-6: the front end
# ---------------------------------------------------------------------------

def pair_set(bank0, bank1, m):
    import numpy as np

    valid = m.valid.cpu().numpy()
    idx = m.idx1.cpu().numpy()
    k0, k1 = bank0.kpts.cpu().numpy(), bank1.kpts.cpu().numpy()
    return {(tuple(k0[i]), tuple(k1[idx[i]])) for i in np.nonzero(valid)[0]}


def kpt_set(bank):
    v = bank.valid.cpu().numpy()
    return set(map(tuple, bank.kpts.cpu().numpy()[v]))


def frontend_phases(images, smi):
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.config import Configs
    from ur_mvo_tpu_torch.ops import cuda_ext
    from ur_mvo_tpu_torch.runtime.extractor import NeuralExtractor

    cam = make_pinhole(W, H, FX, FX, W / 2, H / 2)
    ext = NeuralExtractor(front_end_config(Configs), cam, device="cuda")

    # --- phase 4: the main path, with launch counts ----------------------
    cuda_ext.LAUNCHES.clear()
    banks = [ext.extract(im) for im in images]
    matches = [ext.match(banks[i], banks[i + 1]) for i in range(N_FRAMES - 1)]
    torch.cuda.synchronize()
    launches = dict(cuda_ext.LAUNCHES)
    n_kpts = [int(b.num_valid()) for b in banks]
    n_inliers = [int(m.num_valid()) for m in matches]
    raw = [int(ext.match(banks[i], banks[i + 1], outlier_rejection=False).num_valid()) for i in range(N_FRAMES - 1)]
    for b in banks:
        assert b.kpts.shape == (1024, 2) and b.desc.shape == (1024, 256)
        assert torch.isfinite(b.kpts).all() and torch.isfinite(b.desc).all() and torch.isfinite(b.scores).all()
        norms = b.desc[b.valid].norm(dim=-1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-3), "descriptors not unit norm"
    emit({"phase": "frontend", "keypoints": n_kpts, "matches": raw, "inliers": n_inliers, "launches": launches})
    missing = [k for k in ("stage1_conv", "stage_conv", "attention", "sinkhorn") if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels of the front end never launched: {missing}")
    if min(n_kpts) < MIN_KEYPOINTS:
        raise AssertionError(f"a frame has fewer than {MIN_KEYPOINTS} keypoints: {n_kpts}")
    if min(n_inliers) < MIN_INLIERS:
        raise AssertionError(f"a pair has fewer than {MIN_INLIERS} inlier matches: {n_inliers}")

    # --- phase 5: the same frames through the plain versions on the card --
    plain = NeuralExtractor(front_end_config(Configs), cam, device="cuda", kernels=False)
    pbanks = [plain.extract(im) for im in images]
    overlap = []
    for b, p in zip(banks, pbanks):
        a, c = kpt_set(b), kpt_set(p)
        overlap.append(len(a & c) / max(len(a), len(c), 1))
    # match agreement on the SAME banks isolates the matcher's kernels; the
    # end-to-end figure (each path on its own banks) is reported beside it:
    # the ~2% of keypoints that bf16 rounding moves change every GNN context
    agree, agree_e2e = [], []
    for i in range(N_FRAMES - 1):
        a = pair_set(banks[i], banks[i + 1], ext.match(banks[i], banks[i + 1], outlier_rejection=False))
        c = pair_set(banks[i], banks[i + 1], plain.match(banks[i], banks[i + 1], outlier_rejection=False))
        e = pair_set(pbanks[i], pbanks[i + 1], plain.match(pbanks[i], pbanks[i + 1], outlier_rejection=False))
        agree.append(len(a & c) / max(len(a), len(c), 1))
        agree_e2e.append(len(a & e) / max(len(a), len(e), 1))
    emit({"phase": "parity", "keypoint_overlap": overlap, "match_agreement": agree,
          "match_agreement_own_banks": agree_e2e})
    if min(overlap) < 0.95 or min(agree) < 0.90:
        raise AssertionError(f"kernel path vs plain path: overlap {min(overlap)} (>= 0.95), agreement {min(agree)} (>= 0.90)")

    # --- phase 6: front-end timing -----------------------------------------
    from ur_mvo_tpu_torch.ops.ransac import ransac_fundamental
    from ur_mvo_tpu_torch.ops.matching import gather_match_points

    def host_ms(fn, reps):
        """Median and 75th percentile (with >= 10 samples beyond it) of the
        host time of ``fn(i)`` ending in a device synchronize."""
        fn(0)
        torch.cuda.synchronize()
        ts = []
        for i in range(reps):
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        q = statistics.quantiles(ts, n=4)
        return {"median": statistics.median(ts), "p75": q[2], "n": reps}

    def pair(i):
        j = i % (N_FRAMES - 1)
        return banks[j], banks[j + 1]

    gen = torch.Generator(device="cuda").manual_seed(1)
    raw_m = [ext.match(*pair(i), outlier_rejection=False) for i in range(N_FRAMES - 1)]
    pts = [gather_match_points(m, *(b.kpts for b in pair(i))) for i, m in enumerate(raw_m)]
    ext.reset_state()
    timing = {
        "extract": host_ms(lambda i: ext.extract(images[i % N_FRAMES]), 40),
        "match": host_ms(lambda i: ext.match(*pair(i)), 40),
        "match_no_ransac": host_ms(lambda i: ext.match(*pair(i), outlier_rejection=False), 40),
        "superglue_scores": host_ms(
            lambda i: ext.superglue.match_scores(*pair(i), W, H, num_heads=ext.num_heads), 40),
        "ransac": host_ms(lambda i: ransac_fundamental(gen, *pts[i % (N_FRAMES - 1)]), 40),
        "extract_plain": host_ms(lambda i: plain.extract(images[i % N_FRAMES]), 12),
        "match_plain": host_ms(lambda i: plain.match(*pair(i)), 12),
    }
    emit({"phase": "timing", "unit": "ms", **timing, "card": smi})

    # device busy share of a frame step (extract + match with F-RANSAC) and
    # of extract alone, under the profiler (which adds host time: the idle
    # shares are upper bounds); the largest kernels and host ops per step
    def step():
        b = ext.extract(images[1])
        ext.match(banks[0], b)

    steps = 5
    for name, fn in (("frame_step", step), ("extract", lambda: ext.extract(images[1]))):
        dev, host, wall = profile_device(fn, steps)
        busy = sum(dev.values()) / 1e3 / steps
        emit({"phase": "device_share", "what": name, "unit": "ms per call", "wall": wall / steps,
              "device_busy": busy, "idle_share": 1.0 - busy / (wall / steps),
              "device_launches": host.pop("device records", 0) / steps, "distinct_kernels": len(dev),
              "top_kernels": [[k[:70], v / 1e3 / steps] for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:6]],
              "top_host_ops": [[k[:50], v / 1e3 / steps] for k, v in sorted(host.items(), key=lambda kv: -kv[1])[:8]]})

    # the device kernel before each attention launch of three matches: the
    # wrapper passes the bool mask as it is, so the kernel of a bool -> uint8
    # cast (profiled on its own here) must precede none (the profiler may
    # drop records of a short window, so the counts are of what it kept)
    cast = set(device_kernels(lambda: [banks[0].valid.to(torch.uint8) for _ in range(20)]))
    cuda_ext.LAUNCHES.clear()
    names = device_kernels(lambda: [ext.match(banks[0], banks[1]) for _ in range(3)])
    n_calls = cuda_ext.LAUNCHES["attention"] // 2  # the warm-up matches and the profiled ones
    n_kernels = sum("attention_mma_kernel" in n for n in names)
    before = [names[i - 1] for i, n in enumerate(names) if "attention_mma_kernel" in n and i > 0]
    casts = sum(n in cast for n in before)
    emit({"phase": "device_share", "what": "match_attention", "attention_calls": n_calls,
          "attention_kernels": n_kernels, "cast_kernel": [c[:70] for c in cast],
          "before_attention": {k[:70]: before.count(k) for k in set(before)}, "casts_before_attention": casts})
    if not cast or casts or not n_kernels:
        raise AssertionError(f"a match's attention kernels: {n_kernels} of {n_calls} calls recorded, cast kernel "
                             f"{cast}, {casts} casts right before one")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: windowed BA on the card against the CPU
# ---------------------------------------------------------------------------

def ba_phase():
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops.ba import BAConfig, bundle_adjust
    from ur_mvo_tpu_torch.utils.synthscene import so3_exp
    from ur_mvo_tpu_torch.weights import ba_problem_from_numpy

    rng = np.random.default_rng(12)
    NF, NP, F, P, O = 10, 600, 36, 2048, 8192  # the production window's padding
    fx = fy = 400.0
    cx, cy = 320.0, 256.0
    X_true = rng.uniform([-3, -3, 6], [3, 3, 12], (NP, 3)).astype(np.float32)
    ts = np.linspace(0.0, 1.0, NF)
    t_true = np.stack([2.0 * ts, 0.1 * np.sin(3 * ts), 0.05 * ts], 1).astype(np.float32)
    R_true = np.stack([so3_exp(np.array([0.03 * np.sin(2 * t), 0.1 * t, 0.02 * t])) for t in ts]).astype(np.float32)
    obs_f, obs_p, obs_uv = [], [], []
    for f in range(NF):
        pc = (X_true - t_true[f]) @ R_true[f]
        u = fx * pc[:, 0] / pc[:, 2] + cx
        v = fy * pc[:, 1] / pc[:, 2] + cy
        idx = np.nonzero((pc[:, 2] > 0.1) & (u > 0) & (u < 640) & (v > 0) & (v < 512))[0]
        obs_f.append(np.full(len(idx), f))
        obs_p.append(idx)
        obs_uv.append(np.stack([u[idx] + 0.3 * rng.normal(size=len(idx)), v[idx] + 0.3 * rng.normal(size=len(idx)),
                                -np.ones(len(idx))], 1))
    obs_f, obs_p, obs_uv = np.concatenate(obs_f), np.concatenate(obs_p), np.concatenate(obs_uv).astype(np.float32)
    n_obs = len(obs_f)
    assert n_obs <= O, n_obs
    obs_uv[:60, 0] += 50.0  # gross outliers
    R0 = np.stack([so3_exp(0.02 * rng.normal(size=3)) for _ in range(NF)]).astype(np.float32) @ R_true
    t0 = t_true + 0.1 * rng.normal(size=(NF, 3)).astype(np.float32)
    R0[:2], t0[:2] = R_true[:2], t_true[:2]

    def pad(a, n, tail=(), dtype=np.float32):
        out = np.zeros((n,) + tail, dtype)
        out[: len(a)] = a
        return out

    fields = (
        np.concatenate([R0, np.tile(np.eye(3, dtype=np.float32)[None], (F - NF, 1, 1))]), pad(t0, F, (3,)),
        np.arange(F) < NF, np.arange(F) < 2,
        pad(X_true + 0.05 * rng.normal(size=X_true.shape).astype(np.float32), P, (3,)), np.arange(P) < NP,
        pad(obs_f, O, (), np.int64), pad(obs_p, O, (), np.int64), pad(obs_uv, O, (3,)), np.arange(O) < n_obs,
    )
    geom = (fx, fy, cx, cy, 0.0)
    cfg = BAConfig()
    with torch.no_grad():
        on_card = bundle_adjust(ba_problem_from_numpy(fields, "cuda"), *geom, cfg)
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        on_card = bundle_adjust(ba_problem_from_numpy(fields, "cuda"), *geom, cfg)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0_)
        on_cpu = bundle_adjust(ba_problem_from_numpy(fields, "cpu"), *geom, cfg)
    err_R = (on_card.R_wc.cpu() - on_cpu.R_wc).abs().max().item()
    err_t = (on_card.t_wc.cpu() - on_cpu.t_wc).abs().max().item()
    err_X = (on_card.X.cpu() - on_cpu.X).abs().max().item()
    agree = (on_card.obs_inlier.cpu() == on_cpu.obs_inlier).float().mean().item()
    truth_t = (on_card.t_wc.cpu()[:NF] - torch.from_numpy(t_true)).abs().max().item()
    emit({"phase": "ba", "frames": NF, "points": NP, "observations": n_obs, "padded": [F, P, O],
          "card_vs_cpu": {"R": err_R, "t": err_t, "X": err_X, "inlier_agreement": agree}, "tol": 1e-3,
          "err_t_vs_truth": truth_t, "host_ms_on_card": card_ms})
    if not (err_R <= 1e-3 and err_t <= 1e-3 and err_X <= 5e-3 and agree >= 0.99 and truth_t < 5e-2):
        raise AssertionError(f"bundle_adjust on the card vs the CPU: R {err_R}, t {err_t}, X {err_X}, inliers {agree}")


# ---------------------------------------------------------------------------
# Phase 8: the engine
# ---------------------------------------------------------------------------

def production_config(Configs, checkpoint_operating_point, long_run=False):
    """The production mono configuration of ``scripts/bench_accuracy.py``
    (``_production_cfg`` with matcher ``sg``): the checkpoint's operating
    point, the init-only NN floor of 40, relocalization on. ``long_run``:
    its long-sequence configuration at 480x640, with culling, loop closure
    and the tracking-time NN floor of 40 on too."""
    cfg = front_end_config(Configs, *((LONG_W, LONG_H) if long_run else (W, H)))
    op = checkpoint_operating_point(SG_WEIGHTS) or {}
    cfg.superpoint.capacity = op.get("capacity", 1024)
    cfg.superpoint.max_keypoints = op.get("max_keypoints", 1000)
    cfg.superpoint.keypoint_threshold = op.get("keypoint_threshold", 1e-4)
    cfg.initializer.min_matches = op.get("min_matches", 60)
    cfg.initializer.min_features_first = op.get("min_features_first", 100)
    cfg.superglue.nn_fallback_min_matches_init = 40
    cfg.backend.relocalization = True
    if long_run:
        cfg.backend.enable_culling = True
        cfg.backend.loop_closure = True
        cfg.superglue.nn_fallback_min_matches = 40
    return cfg


def run_engine(vo, frames):
    """Feed the frames (next frame prefetched), pairing emitted poses with
    timestamps as ``scripts/bench_accuracy.py`` does: the poses returned at a
    keyframe cover the interpolated frames since the last emission, so the
    last ``len(poses)`` pending timestamps are theirs. Returns per-frame host
    ms, the emitted timestamps and poses, and the index of the frame that
    initialised."""
    import torch

    per_frame, stamps, poses, pending, init_at = [], [], [], [], None
    for i, f in enumerate(frames):
        pending.append(i / FPS)
        t0 = time.perf_counter()
        out = vo.process(f, next_data=frames[i + 1] if i + 1 < len(frames) else None)
        per_frame.append(1e3 * (time.perf_counter() - t0))
        if out:
            stamps.extend(pending[-len(out):])
            poses.extend(out)
            pending.clear()
        if init_at is None and vo.tracker.initialized:
            init_at = i
    torch.cuda.synchronize()
    return per_frame, stamps, poses, init_at


def emitted_ate(stamps, poses, T_wc):
    """Scale-corrected ATE of the emitted trajectory, the accuracy protocol of
    ``scripts/bench_accuracy.py`` (mono): None below 5 poses, a failed run."""
    import numpy as np

    from ur_mvo_tpu_torch.utils.metrics import ate_rmse

    if len(stamps) < 5:
        return None
    idx = np.clip((np.asarray(stamps) * FPS).round().astype(int), 0, len(T_wc) - 1)
    pos = np.stack([np.asarray(p.translation) for p in poses])
    return float(ate_rmse(pos, T_wc[idx][:, :3, 3], align=True, correct_scale=True))


def keyframe_ate(vo, T_wc):
    import numpy as np

    from ur_mvo_tpu_torch.utils.metrics import ate_rmse

    kts, kpos, _ = vo.keyframe_trajectory()
    idx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, len(T_wc) - 1)
    return float(ate_rmse(kpos, T_wc[idx][:, :3, 3], align=True, correct_scale=True)), kts, kpos


def engine_scene(seed):
    """One 24-frame ``mono/3d`` scene of the accuracy protocol."""
    from ur_mvo_tpu_torch.components import Frame, Image
    from ur_mvo_tpu_torch.utils.synthscene import render_sequence

    images, T_wc, _ = render_sequence(ENGINE_FRAMES, H, W, FX, seed=seed, n_planes=3, z_background=6.0)
    return [Frame(image=Image(images[i], i / FPS)) for i in range(ENGINE_FRAMES)], T_wc


def engine_run(vo, seed, scene=None):
    """Reset the engine, feed it one scene, and score the run."""
    import numpy as np

    frames, T_wc = scene or engine_scene(seed)
    vo.reset()
    per_frame, stamps, poses, init_at = run_engine(vo, frames)
    n_kf = vo.tracker.backend.store.num_keyframes()
    kf_ate, kts, kpos = keyframe_ate(vo, T_wc) if n_kf >= 3 else (None, [], np.zeros((0, 3)))
    row = {"seed": seed, "initialised_at_frame": init_at, "keyframes": n_kf,
           "keyframe_frame_ids": [int(round(t * FPS)) for t in kts], "frames_lost": vo.tracker.frames_lost,
           "relocalizations": vo.tracker.relocalizations, "poses_emitted": len(poses), "poses_finite": all(np.isfinite(p.matrix()).all() for p in poses),
           "ate": emitted_ate(stamps, poses, T_wc), "keyframe_ate": kf_ate}
    return row, per_frame, kpos


def production_engine(kernels=True, long_run=False):
    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.config import Configs
    from ur_mvo_tpu_torch.engine import UR_MVO
    from ur_mvo_tpu_torch.models.superglue import checkpoint_operating_point

    w, h, fx = (LONG_W, LONG_H, LONG_FX) if long_run else (W, H, FX)
    return UR_MVO(production_config(Configs, checkpoint_operating_point, long_run),
                  camera=make_pinhole(w, h, fx, fx, w / 2, h / 2), device="cuda", kernels=kernels)


def engine_sweep(seeds, repeats=2):
    """How the engine fares on scenes of the ``mono/3d`` family, and how
    far one run differs from the next: per
    seed, ``repeats`` runs on the kernels and one on the plain versions."""
    engines = {k: production_engine(k) for k in (True, False)}
    for seed in seeds:
        scene = engine_scene(seed)
        row = {"phase": "engine_sweep", "seed": seed}
        for name, vo in [(f"kernels_{r}", engines[True]) for r in range(repeats)] + [("plain", engines[False])]:
            row[name] = engine_run(vo, seed, scene)[0]
        emit(row)


def check_engine_runs(rows, what, max_lost=None):
    """The accuracy gate of ``tests/test_accuracy_gates.py`` for one matcher
    column (no failed seed, mean ATE under the bound) and the health of each
    run."""
    for r in rows:
        where = f"engine ({what}, seed {r['seed']})"
        if r["initialised_at_frame"] is None:
            raise AssertionError(f"{where}: the sequence did not initialise")
        if r["keyframes"] < MIN_KEYFRAMES:
            raise AssertionError(f"{where}: {r['keyframes']} keyframes (>= {MIN_KEYFRAMES})")
        if r["ate"] is None:
            raise AssertionError(f"{where}: {r['poses_emitted']} poses emitted (>= 5): a failed run of the protocol")
        if not r["poses_finite"]:
            raise AssertionError(f"{where}: an emitted pose is not finite")
        if max_lost is not None and r["frames_lost"] > max_lost:
            raise AssertionError(f"{where}: {r['frames_lost']} frames lost (<= {max_lost})")
    mean = statistics.mean(r["ate"] for r in rows)
    if not mean <= MAX_ATE:
        raise AssertionError(f"engine ({what}): mean ATE {mean} over seeds {ENGINE_SEEDS} (<= {MAX_ATE})")
    return mean


def engine_phase(smi):
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops import cuda_ext, cuda_pose

    # BA's segment sums are index_add_, which adds with atomics on the card;
    # a rounding difference there moves later keyframes, so one run scores
    # unlike the next (--engine-seeds --repeats shows the spread). PyTorch's
    # deterministic index_add_ makes the checked runs repeatable; the timed
    # runs go without it.
    torch.use_deterministic_algorithms(True, warn_only=True)
    scenes = {seed: engine_scene(seed) for seed in ENGINE_SEEDS}
    vo = production_engine()

    # --- the main path, with launch counts -------------------------------
    cuda_ext.LAUNCHES.clear()
    cuda_pose.reset_steps()
    runs = [engine_run(vo, seed, scenes[seed]) for seed in ENGINE_SEEDS]
    launches = dict(cuda_ext.LAUNCHES)
    gn_steps, gn_problems = cuda_pose.steps_run()
    rows = [r[0] for r in runs]
    tracked = vo.tracker.timer.summary().get("track", {}).get("count", 0)
    emit({"phase": "engine", "frames": ENGINE_FRAMES, "seeds": list(ENGINE_SEEDS), "runs": rows,
          "tracked_frames": tracked, "max_ate": MAX_ATE, "launches": launches,
          "pose_gn_problems": gn_problems, "pose_gn_mean_steps": gn_steps / max(gn_problems, 1), "card": smi})
    mean_ate = check_engine_runs(rows, "kernels", max_lost=MAX_FRAMES_LOST)
    missing = [k for k in ENGINE_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"engine: kernels of the main path never launched: {missing}")
    if launches["pose_gn"] < tracked:
        raise AssertionError(f"engine: pose_gn launched {launches['pose_gn']} times for {tracked} tracked frames")

    # --- times, as a user runs it: index_add_ with atomics ----------------
    torch.use_deterministic_algorithms(False)
    vo.tracker.timer.reset()
    timed = [engine_run(vo, seed, scenes[seed]) for seed in ENGINE_SEEDS]
    per_frame = [ms for r in timed for ms in r[1]]
    steady = [ms for r in timed for ms in r[1][(r[0]["initialised_at_frame"] or 0) + 1:]]
    stages = {k: {"count": v["count"], "mean_ms": v["mean_ms"], "max_ms": v["max_ms"]}
              for k, v in vo.tracker.timer.summary().items()}
    emit({"phase": "engine_timing", "unit": "host ms", "runs": [r[0] for r in timed], "per_stage": stages,
          "per_frame": {"mean": statistics.mean(per_frame), "median": statistics.median(per_frame),
                        "median_after_init": statistics.median(steady) if steady else None,
                        "max": max(per_frame)},
          "card": smi})

    # --- device share of one whole sequence, under the profiler -----------
    seed = ENGINE_SEEDS[0]

    def whole_run():
        engine_run(vo, seed, scenes[seed])

    dev, host, wall = profile_device(whole_run, 1)
    busy = sum(dev.values()) / 1e3
    emit({"phase": "device_share", "what": "engine_run", "unit": "ms per frame", "wall": wall / ENGINE_FRAMES,
          "device_busy": busy / ENGINE_FRAMES, "idle_share": 1.0 - busy / wall,
          "device_launches": host.pop("device records", 0) / ENGINE_FRAMES,
          "top_kernels": [[k[:70], v / 1e3 / ENGINE_FRAMES] for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:8]],
          "top_host_ops": [[k[:50], v / 1e3 / ENGINE_FRAMES] for k, v in sorted(host.items(), key=lambda kv: -kv[1])[:8]]})

    # how far a second deterministic run of the first scene lands from the first
    torch.use_deterministic_algorithms(True, warn_only=True)
    again, _, kpos_again = engine_run(vo, seed, scenes[seed])
    kpos = runs[0][2]
    shift = float(np.abs(kpos_again - kpos).max()) if kpos_again.shape == kpos.shape else None

    # --- the same sequences through the plain versions on the card --------
    plain = production_engine(kernels=False)
    cuda_ext.LAUNCHES.clear()
    plain_runs = [engine_run(plain, s, scenes[s]) for s in ENGINE_SEEDS]
    plain_launches = dict(cuda_ext.LAUNCHES)
    emit({"phase": "engine_plain", "runs": [r[0] for r in plain_runs], "kernel_launches": plain_launches,
          "ms_per_frame_median": statistics.median(ms for r in plain_runs for ms in r[1]),
          "mean_ate": {"kernels": mean_ate, "plain": statistics.mean(r[0]["ate"] or float("nan") for r in plain_runs)},
          "second_kernel_run_of_first_seed": {"ate": again["ate"], "keyframe_ate": again["keyframe_ate"],
                                              "max_keyframe_position_shift": shift}})
    if plain_launches:
        raise AssertionError(f"engine with kernels=False launched kernels: {plain_launches}")
    check_engine_runs([r[0] for r in plain_runs], "plain versions")
    vo.shutdown()
    plain.shutdown()
    torch.use_deterministic_algorithms(False)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 2
    from ur_mvo_tpu_torch.ops import cuda_ext
    from ur_mvo_tpu_torch.utils.synthscene import render_sequence

    # --- phase 1: device ---------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # --- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    cuda_ext.extension(verbose="--ptxas" in sys.argv)
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    if "--engine-seeds" in sys.argv:
        if "--deterministic" in sys.argv:
            torch.use_deterministic_algorithms(True, warn_only=True)
        engine_sweep([int(x) for x in sys.argv[sys.argv.index("--engine-seeds") + 1].split(",")],
                     repeats=int(sys.argv[sys.argv.index("--repeats") + 1]) if "--repeats" in sys.argv else 2)
        print(smi, flush=True)
        return 0
    if "--long-seeds" in sys.argv:
        long_sweep([int(x) for x in sys.argv[sys.argv.index("--long-seeds") + 1].split(",")],
                   plain="--plain" in sys.argv, audit="--audit" in sys.argv,
                   attention=sys.argv[sys.argv.index("--attention") + 1] if "--attention" in sys.argv else "kernel")
        print(smi, flush=True)
        return 0
    if "--only-attention" in sys.argv:
        try:
            attention_phase(torch.Generator(device="cuda").manual_seed(0))
        except AssertionError as e:
            emit({"phase": "kernels", "kernel": "attention", "failed": str(e)})
            print(smi, flush=True)
            return 1
        print(smi, flush=True)
        return 0
    if "--stage-digest" in sys.argv:
        digest, parts = stage_conv_digest()
        emit({"stage_conv_digest": digest, "parts": parts})
        print(smi, flush=True)
        return 0
    if "--only-stage-conv" in sys.argv:
        try:
            stage_phase(render_sequence(N_FRAMES, H, W, FX, seed=0)[0][0])
        except AssertionError as e:
            emit({"phase": "kernels", "kernel": "stage_conv", "failed": str(e)})
            print(smi, flush=True)
            return 1
        print(smi, flush=True)
        return 0
    if "--sinkhorn-digest" in sys.argv:
        from ur_mvo_tpu_torch.ops import cuda_kernels

        digest, parts = sinkhorn_digest()
        C, mu, nu = sinkhorn_inputs(1025, 1025)
        call = lambda: cuda_kernels.sinkhorn(C, mu, nu, 20)  # noqa: E731
        emit({"sinkhorn_digest": digest, "parts": parts, "ms_all_device_records": device_ms(call)[0],
              "wall_ms": time_ms(call), "device_records_a_call": len(device_kernels(call, opener=True))})
        print(smi, flush=True)
        return 0
    if "--only-sinkhorn" in sys.argv:
        try:
            sinkhorn_phase()
        except AssertionError as e:
            emit({"phase": "kernels", "kernel": "sinkhorn", "failed": str(e)})
            print(smi, flush=True)
            return 1
        print(smi, flush=True)
        return 0
    if "--pose-gn-digest" in sys.argv:
        digest, parts = pose_gn_digest()
        emit({"pose_gn_digest": digest, "parts": parts, "B=2 N=1024": pose_gn_time(*pose_digest_cases()[0][1])})
        print(smi, flush=True)
        return 0
    if "--only-pose-gn" in sys.argv:
        try:
            pose_gn_phase()
        except AssertionError as e:
            emit({"phase": "kernels", "kernel": "pose_gn", "failed": str(e)})
            print(smi, flush=True)
            return 1
        print(smi, flush=True)
        return 0
    if "--only-ba-kernels" in sys.argv:
        ba_kernels_phase(smi)
        print(smi, flush=True)
        return 0
    if "--only-ba" in sys.argv:
        torch.use_deterministic_algorithms(True, warn_only=True)
        _, (F, P, O) = long_map_global_optimize(smi, production_engine(long_run=True).tracker.backend)
        torch.use_deterministic_algorithms(False)
        ba_kernels_phase(smi, ((P, O, F), BA_KERNEL_SHAPES[1]))
        global_ba_phase(smi)
        print(smi, flush=True)
        return 0

    seconds, failed = {}, []

    def timed(name, fn, *args, on_failure=None):
        """Run a phase; a failed check is printed and the run goes on to
        the next phase (``on_failure`` stands in for its result), so that
        one run shows every phase. The result line needs all to pass."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except AssertionError as e:
            emit({"phase": name, "failed": str(e)})
            failed.append(name)
            return on_failure
        finally:
            torch.use_deterministic_algorithms(False)
            seconds[name] = time.perf_counter() - t0

    images, _, _ = render_sequence(N_FRAMES, H, W, FX, seed=0)
    rows = timed("kernels", kernel_phase, images, on_failure={})
    rows["pose_gn"] = timed("pose_gn", pose_gn_phase)
    timed("frontend", frontend_phases, images, smi)
    timed("ba", ba_phase)
    launches = timed("engine", engine_phase, smi, on_failure={})
    long_launches, long_shape = timed("long", long_phase, smi, on_failure=({}, BA_KERNEL_SHAPES[0]))
    rows.update(timed("ba_kernels", ba_kernels_phase, smi, (long_shape, BA_KERNEL_SHAPES[1]), on_failure={}))
    # the sorted kernel's launches are those of global_optimize's full BA;
    # the unsorted kernel runs only where "pallas" is asked for
    launches["point_reduce_sorted"] = long_launches.get("point_reduce_sorted", 0)
    launches["point_reduce"] = timed("global_ba", global_ba_phase, smi, on_failure={}).get("point_reduce", 0)
    emit({"phase": "seconds", **seconds, "total": time.perf_counter() - T_START})
    if failed:
        print(smi, flush=True)
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1

    kernels = []
    for name in TPU_KERNELS:
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": TPU_KERNELS[name],
            "launches": launches.get(name, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
