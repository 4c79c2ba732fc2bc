"""The mesh BA's ``all_reduce`` traffic a LM step (the count that
``scripts/bench_scaling.py`` and ``scripts/validate_ici_model.py`` feed
their interconnect model, taken from the port's own collectives).

Runs ``parallel.dist_ba.shard_problem`` and ``dist_bundle_adjust`` on
``bench_scaling.py``'s default problem (32 frames, 8,192 points, 32,768
observations, 15 LM iterations with the convergence exit off) at each
world size, a process a rank, and prints one JSON line a world: the LM
steps, the ``all_reduce`` calls and bytes that ``parallel.mesh.all_sum``
counted (a step, and in all), the same worked out from the packed terms
(``H_cc`` (FF, 6, 6), ``b_c`` (FF, 6), ``S_red`` (6FF, 6FF) and ``b_red``
(6FF) in one call a step, the cost in one more), and the JAX package's
count from its source (5 ``psum`` calls, 39,940 bytes a step at FF = 16).
It claims no scaling and predicts no efficiency (the JAX scripts' model is
of the TPU's interconnect); each rank's seconds for the call are printed
as they came (``seconds_not_a_rate``), a build and warm-up included.

Usage:
  python -m ur_mvo_tpu_torch.cli.bench_scaling [--worlds 1 2] [--device cuda|cpu] [--backend nccl|gloo]

``--device`` defaults to ``cuda`` and raises without it; ranks share the
cards round-robin, and a world with more ranks than cards runs gloo (NCCL
refuses two ranks on one card) unless ``--backend`` names one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FRAMES, POINTS, OBS, ITERS = 32, 8192, 32768, 15
RANK_DEADLINE_S = 300
# the JAX package's count from its source (scripts/validate_ici_model.py:4-9,
# scripts/bench_scaling.py:109-116): psum calls and bytes a LM iteration at
# FF = 16
JAX_SOURCE_COUNT = {"psum_calls_a_step": 5, "psum_bytes_a_step": 39940, "max_free_frames": 16}


def make_problem(frames: int = FRAMES, points: int = POINTS, obs: int = OBS, device="cpu"):
    """``bench_scaling.py``'s problem, the same draws: points in a
    8 x 8 x 6 m box, frames along x, each frame seeing the same random
    points, ~10% padding; two fixed frames. Returns ``(BAProblem, fx, fy,
    cx, cy)``."""
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops.ba import BAProblem

    rng = np.random.default_rng(0)
    n_frames = frames - 2
    n_pts = points - points // 8
    O_fill = obs - obs // 10
    fx = fy = 413.3
    cx, cy = 320.0, 256.0
    Xw = rng.uniform([-4, -4, 4], [4, 4, 10], (n_pts, 3)).astype(np.float32)
    t_wc = np.stack([np.linspace(0, 2, n_frames), np.zeros(n_frames), np.zeros(n_frames)], 1).astype(np.float32)
    per = O_fill // n_frames
    obs_f = np.repeat(np.arange(n_frames), per)
    obs_p = np.tile(rng.integers(0, n_pts, per), n_frames)
    order = np.lexsort((obs_f, obs_p))
    obs_f, obs_p = obs_f[order], obs_p[order]
    u = fx * (Xw[obs_p][:, 0] - t_wc[obs_f][:, 0]) / Xw[obs_p][:, 2] + cx
    v = fy * Xw[obs_p][:, 1] / Xw[obs_p][:, 2] + cy
    obs_uv = np.stack([u, v, -np.ones_like(u)], 1).astype(np.float32)

    def pad(a, n, tail=(), dtype=np.float32):
        out = np.zeros((n,) + tail, dtype)
        out[: len(a)] = np.asarray(a, dtype).reshape((-1,) + tail)[:n]
        return torch.from_numpy(out).to(device)

    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    prob = BAProblem(
        R_wc=torch.eye(3, device=device).expand(frames, 3, 3).contiguous(),
        t_wc=pad(t_wc, frames, (3,)),
        frame_valid=ar(frames) < n_frames,
        frame_fixed=ar(frames) < 2,
        X=pad(Xw, points, (3,)),
        point_valid=ar(points) < n_pts,
        obs_frame=pad(obs_f, obs, (), np.int64),
        obs_point=pad(obs_p, obs, (), np.int64),
        obs_uv=pad(obs_uv, obs, (3,)),
        obs_valid=ar(obs) < len(obs_f),
    )
    return prob, fx, fy, cx, cy


def packed_terms(cfg) -> dict:
    """What ``dist_bundle_adjust`` sums, from its packed terms (float32):
    each LM step one call of ``H_cc``, ``b_c``, ``S_red`` and ``b_red`` and
    one of the trial cost; each LM phase one more call for its starting
    cost. Returns the calls and bytes a step, a phase's own, and the whole
    call's for ``cfg``'s iterations."""
    FF = cfg.max_free_frames
    step_bytes = 4 * (FF * 36 + FF * 6 + (6 * FF) ** 2 + 6 * FF) + 4
    steps = cfg.iters_phase1 + cfg.iters_phase2
    return {"calls_a_step": 2, "bytes_a_step": step_bytes, "calls_a_phase": 1, "bytes_a_phase": 4,
            "steps": steps, "calls": 2 * steps + 2, "bytes": steps * step_bytes + 2 * 4}


def count_all_reduce(mesh, device, frames: int = FRAMES, points: int = POINTS, obs: int = OBS,
                     iters: int = ITERS) -> dict:
    """Shard the problem over ``mesh`` and run ``dist_bundle_adjust`` once
    (``iters`` phase-1 steps, no phase 2, no convergence exit), counting
    ``all_sum``'s calls and bytes: the counts, those a step (past each
    phase's starting cost), the packed terms' and the JAX source's."""
    import torch

    from ur_mvo_tpu_torch.ops.ba import BAConfig
    from ur_mvo_tpu_torch.parallel import mesh as tmesh
    from ur_mvo_tpu_torch.parallel.dist_ba import dist_bundle_adjust, shard_problem

    prob, fx, fy, cx, cy = make_problem(frames, points, obs, device)
    cfg = BAConfig(iters_phase1=iters, iters_phase2=0, tol=0.0)
    prob_s, _ = shard_problem(prob, mesh.size())
    before = dict(tmesh.ALL_SUM)
    t0 = time.perf_counter()
    res = dist_bundle_adjust(prob_s, mesh, fx, fy, cx, cy, 0.0, cfg)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    calls = tmesh.ALL_SUM["calls"] - before.get("calls", 0)
    nbytes = tmesh.ALL_SUM["bytes"] - before.get("bytes", 0)
    formula = packed_terms(cfg)
    phases = 2  # phase 2 runs no step but sums its starting cost
    return {"world": mesh.size(), "rank": mesh.get_local_rank(),
            "problem": {"frames": frames, "points": points, "obs": obs, "max_free_frames": cfg.max_free_frames},
            "lm_steps": formula["steps"], "all_reduce_calls": calls, "all_reduce_bytes": nbytes,
            "calls_a_step": (calls - phases * formula["calls_a_phase"]) / formula["steps"],
            "bytes_a_step": (nbytes - phases * formula["bytes_a_phase"]) / formula["steps"],
            "packed_terms": formula, "jax_source": JAX_SOURCE_COUNT, "cost": float(res.cost),
            "seconds_not_a_rate": seconds}


def _rank_main(rank: int, world: int, backend: str, device: str, workdir: str, frames, points, obs, iters) -> None:
    import torch

    from ur_mvo_tpu_torch.parallel import mesh as tmesh

    if device.startswith("cuda"):
        device = f"cuda:{rank % torch.cuda.device_count()}"
    dev = tmesh.init_distributed(backend, init_method=f"file://{workdir}/rendezvous", world_size=world, rank=rank,
                                 device=device)
    try:
        out = count_all_reduce(tmesh.make_mesh(world), dev, frames, points, obs, iters)
    finally:
        torch.distributed.destroy_process_group()
    out["backend"] = backend
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run_world(world: int, device: str, backend: Optional[str] = None, frames: int = FRAMES, points: int = POINTS,
              obs: int = OBS, iters: int = ITERS, deadline_s: float = RANK_DEADLINE_S) -> list:
    """``world`` ranks of :func:`count_all_reduce`, a process each (this
    module with ``--rank``), killed past ``deadline_s``; returns each
    rank's result. A rank that fails raises."""
    import torch

    if backend is None:
        cards = torch.cuda.device_count() if device.startswith("cuda") else 0
        backend = "nccl" if device.startswith("cuda") and world <= cards else "gloo"
    with tempfile.TemporaryDirectory() as workdir:
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ur_mvo_tpu_torch.cli.bench_scaling", "--rank", str(r), "--worlds", str(world),
             "--backend", backend, "--device", device, "--frames", str(frames), "--points", str(points),
             "--obs", str(obs), "--iters", str(iters), "--workdir", workdir],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
        deadline, logs = time.monotonic() + deadline_s, []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"bench_scaling: rank {r} of world {world} exited {p.returncode}:\n{log[-3000:]}")
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                out.append(json.load(f))
    return out


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run the command line ``argv``; returns one result a world (rank 0's,
    with every rank's counts under ``"ranks"``)."""
    ap = argparse.ArgumentParser(prog="python -m ur_mvo_tpu_torch.cli.bench_scaling")
    ap.add_argument("--worlds", type=int, nargs="*", default=[1, 2], help="world sizes, a process a rank")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs gloo on the CPU)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--points", type=int, default=POINTS)
    ap.add_argument("--obs", type=int, default=OBS)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from ur_mvo_tpu_torch.device import resolve_device

    resolve_device(args.device)
    if args.rank is not None:
        _rank_main(args.rank, args.worlds[0], args.backend, args.device, args.workdir, args.frames, args.points,
                   args.obs, args.iters)
        return []
    results = []
    for world in args.worlds:
        ranks = run_world(world, args.device, args.backend, args.frames, args.points, args.obs, args.iters)
        line = {**ranks[0], "ranks": [{k: r[k] for k in ("rank", "all_reduce_calls", "all_reduce_bytes")}
                                      for r in ranks]}
        line.pop("rank")
        print(json.dumps(line), flush=True)
        results.append(line)
    return results


if __name__ == "__main__":
    main()
