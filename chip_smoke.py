#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's front end (``ur_mvo_tpu_torch``) on one card.

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
   attention also the errors of a swapped mask and of a dropped key tile,
   which must exceed it); Sinkhorn's time also beside the time the card
   takes to read its matrix once per half-sweep from L2; its
   device time per launch from ``torch.profiler`` beside the plain version's
   and, where one exists, a PyTorch library call's, the wall time of a
   wrapper call, and the least time the card could take (``bound_ms``);
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
   ``torch.profiler``.

Then the ``kernels`` line, the ``nvidia-smi`` name/power-limit line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises, so the
exit code is not 0 and that last line is not printed. Without CUDA it exits
with code 2 before doing anything.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SP_WEIGHTS = os.path.join(REPO, "weights", "superpoint_scratch_v3.npz")
SG_WEIGHTS = os.path.join(REPO, "weights", "superglue_v3scene.npz")
H, W, FX = 240, 320, 260.0
N_FRAMES = 8
MIN_KEYPOINTS = 100
MIN_INLIERS = 60  # superglue_v3scene's __meta_op_min_matches__

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32 CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

TPU_KERNELS = {
    "stage1_conv": "ur_mvo_tpu/ops/pallas_conv.py:106",
    "stage_conv": "ur_mvo_tpu/ops/pallas_conv.py:140",
    "attention": "ur_mvo_tpu/ops/pallas_kernels.py:122",
    "sinkhorn": "ur_mvo_tpu/ops/pallas_kernels.py:31",
}
SOURCES = {
    "stage1_conv": "ur_mvo_tpu_torch/csrc/stage_conv.cu",
    "stage_conv": "ur_mvo_tpu_torch/csrc/stage_conv.cu",
    "attention": "ur_mvo_tpu_torch/csrc/attention.cu",
    "sinkhorn": "ur_mvo_tpu_torch/csrc/sinkhorn.cu",
}


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


def device_ms(fn, names=None, calls: int = 20):
    """Device time per call of ``fn`` from the profiler's kernel records: of
    the kernels whose name contains one of ``names``, or of every kernel.
    Where the profiler records no device time, CUDA events around
    back-to-back calls instead (returned with the timer's name)."""
    by_name, _, _ = profile_device(fn, calls)
    us = sum(v for k, v in by_name.items() if names is None or any(n in k for n in names))
    if us > 0:
        return us / 1e3 / calls, "profiler"
    return time_ms(fn), "events"


def timings(kernel, names, plain, library=None, plain_calls: int = 20):
    """``ms``: device time per call of the kernel's own CUDA kernels;
    ``wall_ms``: CUDA-event time per wrapper call, back to back (host work
    included); ``plain_ms`` / ``library_ms``: device time per call of every
    kernel the plain version / the library call runs."""
    ms, timer = device_ms(kernel, names)
    return {
        "ms": ms, "timer": timer, "wall_ms": time_ms(kernel),
        "plain_ms": device_ms(plain, calls=plain_calls)[0],
        "library_ms": None if library is None else device_ms(library)[0],
    }


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def front_end_config(Configs):
    cfg = Configs()
    cfg.superpoint.weights_path = SP_WEIGHTS
    cfg.superglue.weights_path = SG_WEIGHTS
    cfg.superpoint.capacity = 1024
    cfg.superpoint.max_keypoints = 1000
    cfg.superpoint.keypoint_threshold = 1e-4
    cfg.superglue.image_width, cfg.superglue.image_height = W, H
    cfg.runtime.compute_dtype = "bfloat16"
    return cfg


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(images):
    import torch
    import torch.nn.functional as F

    from ur_mvo_tpu_torch.models.superpoint import SuperPoint, load_torch_weights
    from ur_mvo_tpu_torch.ops import cuda_conv, cuda_kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # --- encoder stages on a rendered frame with the shipped weights ------
    sp = SuperPoint()
    sp.load_state_dict(load_torch_weights(SP_WEIGHTS))
    sp = sp.to(device=dev, dtype=torch.bfloat16)
    x = (torch.as_tensor(images[0], device=dev).float() / 255.0).to(torch.bfloat16)[None, :, :, None]
    stage_rows = []
    for name, (na, nb) in zip(("stage1", "stage2", "stage3"), (("conv1a", "conv1b"), ("conv2a", "conv2b"), ("conv3a", "conv3b"))):
        ca, cb = getattr(sp, na), getattr(sp, nb)
        args = (x, ca.weight, ca.bias, cb.weight, cb.bias)
        packed = cuda_conv.pack_stage(*args[1:], x.dtype)  # packed once, as SuperPoint does
        out = cuda_conv.stage_conv(*args, packed=packed)
        ref = cuda_conv.stage_conv_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # two bf16 ulps of the largest output: the two versions sum in another
        # order, which can move conv_a's rounding by one ulp, and the output's
        tol = 2.0**-6 * ref.float().abs().max().item()
        _, Hs, Ws, Cin = x.shape
        Cmid, Cout = ca.weight.shape[0], cb.weight.shape[0]
        xl = x.permute(0, 3, 1, 2)  # NCHW view of NHWC (channels_last)

        def library():
            a = F.relu(F.conv2d(xl, ca.weight, ca.bias, padding=1))
            b = F.relu(F.conv2d(a, cb.weight, cb.bias, padding=1))
            return F.max_pool2d(b, 2)

        flops = 2.0 * Hs * Ws * 9 * (Cin * Cmid + Cmid * Cout)
        nbytes = 2.0 * (Hs * Ws * Cin + (Hs // 2) * (Ws // 2) * Cout + 9 * (Cin * Cmid + Cmid * Cout) + Cmid + Cout)
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16)
        row = {
            "shape": f"{Hs}x{Ws} {Cin}->{Cmid}->{Cout}",
            "max_abs_err": err, "tol": tol,
            **timings(lambda: cuda_conv.stage_conv(*args, packed=packed), ("stage_mma_kernel",),
                      lambda: cuda_conv.stage_conv_plain(*args), library),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
        }
        emit({"phase": "kernels", "kernel": name, **row})
        if not err <= tol:
            raise AssertionError(f"{name}: kernel vs plain max |err| {err} > {tol}")
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
    rows["stage1_conv"] = stage_rows[0]

    def mean_row(rs):
        out = {k: sum(r[k] for r in rs) / len(rs) for k in ("ms", "wall_ms", "plain_ms", "library_ms", "bound_ms")}
        out["max_abs_err"] = max(r["max_abs_err"] for r in rs)
        out["bound_by"] = rs[0]["bound_by"]
        return out

    # one kernel serves stages 2 and 3: per-launch figures are the mean of the two
    rows["stage_conv"] = mean_row(stage_rows[1:])

    # --- attention at B=2, H=4, K=1024, d=64 ------------------------------
    # The two banks of a pair hold different valid counts, so a kernel that
    # read the other batch item's mask (cross-attention passes the other
    # bank's validity) would disagree; (0, 0) is a bank with no valid key.
    B, K, Hh, d = 2, 1024, 4, 64
    for dtype, counts in ((torch.bfloat16, (1000, 937)), (torch.bfloat16, (0, 0)), (torch.float32, (1000, 937))):
        q, k, v = (torch.randn((B, K, Hh, d), generator=gen, device=dev).to(dtype) for _ in range(3))
        valid = torch.arange(K, device=dev)[None] < torch.tensor(counts, device=dev)[:, None]
        out = cuda_kernels.attention(q, k, v, valid)
        ref = cuda_kernels.attention_plain(q, k, v, valid)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # f32: the JAX package's bound; bf16: 2^-6 of max |out|, about two bf16
        # ulps of the largest output (probabilities and outputs round to bf16
        # at different points in the two versions)
        tol = 2e-5 if dtype == torch.float32 else 2.0**-6 * ref.float().abs().max().item()
        row = {"dtype": str(dtype).split(".")[-1], "valid": list(counts), "max_abs_err": err, "tol": tol}
        if dtype == torch.float32:
            row["ms"] = device_ms(lambda: cuda_kernels.attention(q, k, v, valid), ("attention_fma_kernel",))[0]
        if dtype == torch.bfloat16 and counts[0]:
            # the check can fail: the plain version with the batch items'
            # masks swapped, or with the first 64-key tile dropped, must
            # each miss the tolerance
            dropped = valid.clone()
            dropped[:, :64] = False
            row["wrong_mask_err"] = (cuda_kernels.attention_plain(q, k, v, valid.flip(0)).float() - ref.float()).abs().max().item()
            row["dropped_tile_err"] = (cuda_kernels.attention_plain(q, k, v, dropped).float() - ref.float()).abs().max().item()
            mask = torch.where(valid, 0.0, -1e9).to(dtype)[:, None, None, :]
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            flops = 4.0 * B * Hh * K * K * d
            nbytes = 2.0 * 4 * B * K * Hh * d + B * K
            b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16)
            row.update({
                **timings(lambda: cuda_kernels.attention(q, k, v, valid), ("attention_mma_kernel",),
                          lambda: cuda_kernels.attention_plain(q, k, v, valid),
                          lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)),
                "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
            })
            rows["attention"] = dict(row)
        emit({"phase": "kernels", "kernel": "attention", **row})
        if not err <= tol:
            raise AssertionError(f"attention {row['dtype']} valid={counts}: max |err| {err} > {tol}")
        if "wrong_mask_err" in row and not min(row["wrong_mask_err"], row["dropped_tile_err"]) > tol:
            raise AssertionError(f"attention: tolerance {tol} does not tell a wrong mask or a dropped tile from the right result")

    # --- Sinkhorn at 1025 x 1025 ------------------------------------------
    sink_errs = []
    for n0, n1 in ((1000, 1000), (950, 1000)):
        scores = 3.0 * torch.randn((K, K), generator=gen, device=dev)
        v0 = torch.arange(K, device=dev) < n0
        v1 = torch.arange(K, device=dev) < n1
        alpha = torch.tensor(1.5, device=dev)
        Z = cuda_kernels.log_optimal_transport_kernel(scores, v0, v1, alpha, 20)
        Zp = cuda_kernels.log_optimal_transport_kernel(scores, v0, v1, alpha, 20, plain=True)
        torch.cuda.synchronize()
        one = torch.ones(1, dtype=torch.bool, device=dev)
        pair = torch.cat([v0, one])[:, None] & torch.cat([v1, one])[None, :]
        err = (Z - Zp).abs()[pair].max().item()
        tol = 1e-4  # valid block + dustbins, the JAX package's bound
        sink_errs.append(err)
        row = {"valid": [n0, n1], "max_abs_err": err, "tol": tol}
        if n0 == 950:
            M = N = K + 1
            iters = 20
            C = torch.randn((M, N), generator=gen, device=dev)
            mu, nu = torch.randn(M, generator=gen, device=dev), torch.randn(N, generator=gen, device=dev)
            ops = iters * 2 * M * N * 6 + 2 * M * N  # per element and half-sweep: add, max; add, sub, exp, add
            nbytes = 4.0 * (2 * M * N + 2 * (M + N))
            b_ms, b_by = bound_ms(nbytes, ops, PEAK_F32)
            # the 40 half-sweeps each read the matrix once, from L2: the time
            # the card takes to read it that often, measured as one reduction
            # over the matrix expanded 2 * iters times (stride 0, so L2-resident)
            l2_ms = device_ms(lambda: C.expand(2 * iters, M, N).sum())[0]
            row.update({
                **timings(lambda: cuda_kernels.sinkhorn(C, mu, nu, iters), ("row_sweep", "col_sweep", "finalize"),
                          lambda: cuda_kernels.sinkhorn_plain(C, mu, nu, iters), plain_calls=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "l2_sweeps_bound_ms": l2_ms, "l2_read_tb_s": 2 * iters * 4.0 * M * N / (l2_ms * 1e-3) / 1e12,
            })
            rows["sinkhorn"] = dict(row)
        emit({"phase": "kernels", "kernel": "sinkhorn", **row})
        if not err <= tol:
            raise AssertionError(f"sinkhorn valid={n0}/{n1}: max |err| {err} > {tol}")
    rows["sinkhorn"]["max_abs_err"] = max(sink_errs)
    return rows


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
    missing = [k for k in TPU_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels of the main path never launched: {missing}")
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

    images, _, _ = render_sequence(N_FRAMES, H, W, FX, seed=0)
    rows = kernel_phase(images)
    launches = frontend_phases(images, smi)

    kernels = []
    for name in ("stage1_conv", "stage_conv", "attention", "sinkhorn"):
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
