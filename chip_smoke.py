#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``ur_mvo_tpu_torch``) on one card: its
kernels, its front end, the whole monocular engine and its long,
loop-bearing protocol with global optimization, the stereo and RGB-D
engines with the hybrid matcher, the tracking and map extras
(local-map tracking, resolution buckets, sub-pixel peaks, patch
descriptors, map snapshots), several sequences stepped lock-step, the
mesh paths (sequences, pairs and a global BA sharded over ranks), the
sequence entry points (chunked tracking, the command line), training
and export (SuperPoint pretraining and fine-tuning through the stage op's
gradient, SuperGlue training, the data-parallel step, the exported frame
step), and the accuracy matrix through its command line with the shipped
stereo checkpoint.

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
   ``torch.profiler``; every attention call of a match must get the bool
   mask with no bool -> uint8 conversion dispatched since the call before
   it (``attention_mask_witness``, which sees every aten op; a control that
   casts before each call must show), and the kernels the profiler records
   right before a match's attention kernels are reported beside it;
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
   through the plain versions on the card, held to the same gate, each
   seed's initialisation frame, frames lost (those against a collapsed
   map, a reference keyframe with fewer than 6 triangulated points, counted
   apart as phases 14 and 18 count them) and poses emitted printed beside
   the kernel run's (printed, not held: the plain runs' losses are
   reference behaviour, ROADMAP C2). The checked
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
10. metric (in a process of its own, ``--metric-side``, beside phases 9
   and 13 and phase 18's processes: its lines print when it ends): the metric setups through
   ``UR_MVO(cfg, SensorSetup.STEREO | RGBD, device="cuda")`` with the production configuration and matcher
   ``hybrid`` (mutual-NN, SuperGlue's matches where NN has fewer than 40),
   under deterministic algorithms, launch counts reset just before each
   protocol: ``stereo/3d`` and ``rgbd/3d`` of ``scripts/bench_accuracy.py``
   (24 frames at 240x320, fx 260, seeds 11-13; stereo renders a right image
   0.12 m to the right, bf = fx x 0.12; RGB-D reads the rendered metric
   depth) on the kernels and on the plain versions, and ``rgbd/long`` (its
   long configuration, 120 frames at 480x640) on the kernels. The stereo
   and RGB-D BAs sum the point side of bf16 summands, as the JAX package's
   window route does (``BAConfig.bf16_point_side``). Per run the
   init that fired (``_init_stereo`` / ``_init_rgbd``, as it must be),
   keyframes, frames lost, relocalizations, the ATE without scale
   correction, the pose-GN problems of the tracking steps with their mean
   valid and stereo rows, and for ``rgbd/long`` the ATE after
   ``global_optimize()`` and its full BA's size and resolved assembly.
   Gates of ``tests/test_accuracy_gates.py``: no failed seed, mean ATE <
   0.60 (``stereo/3d``) and < 0.15 (``rgbd/3d``), ``rgbd/long`` online <
   0.30 and after global optimization < 0.25; every run >= 3 keyframes,
   on the kernels <= 6 frames lost; every kernel of each path must launch,
   and pose GN must be fed stereo rows on ``stereo/3d``;
11. ba_kernels: both BA point-reduce kernels against their plain versions
   at that full BA's shape (its power-of-two buckets) and at a global BA's
   (65,536 points, 524,288 observations, FF 48): within 1e-5 of max
   |plain|, the sorted kernel bit for bit equal over two launches, points
   without observations exact zeros, and a slot id or a point rank off by
   one must miss the limit; device ms after a read that evicts the L2
   (and back to back), wall, plain, the ``index_add_`` yardstick and the
   bound;
12. global_ba: ``bundle_adjust`` at that global size: ``"auto"`` must
   resolve to ``"sorted"`` and launch the sorted kernel, and its solution
   must agree with the plain assembly on the card (R 1e-3, t 1e-3, X 5e-3,
   inliers >= 99%) and reach the truth (t 5e-2, R 5e-3); the explicit
   ``"pallas"`` (the unsorted kernel, atomics) likewise with its worst
   point within 5e-2, a limit that the plain assembly on shuffled
   observations must meet and a wrong slot assembly must miss; host ms.

13. extras: the features a user turns on through ``Configs`` and the
   engine's map API, at the production operating point, under deterministic
   algorithms, launch counts reset before each path:
   ``mono/3d+local_map`` (``local_map_tracking.enabled`` over the ``mono/3d``
   scenes: initialised, >= 3 keyframes, finite poses, <= 6 frames lost;
   per seed the ATE, the local-map steps, the steps whose
   pose was kept, associations added and the ``pose_gn`` launches of the
   local-map steps apart from the track step's, which must be > 0; every
   captured local-map problem, N = 1024 and one round, through the kernel
   against the plain optimizer's full schedule at phase 3's limits or, where
   a few-inlier round stops at a fixed point that the sums' rounding picks,
   those of the plain version run on its rows in another order (up to 64
   orders drawn), where a near miss (the kernel's t moved 1.5 limits) must
   fail the same search, with a 4-round control that must miss, and the
   times); ``buckets`` (frame 0 of seed 11 through a (288, 384) bucket
   against the native extraction: > 99% of the interior keypoints within
   0.5 px, all inside the trimmed image; a 216x288 crop through it; the
   bucketed bank against the plain versions, phase 5's overlap; the stage
   kernels launched at 288x384; a 16-frame engine pass through a (240, 320)
   bucket with every third frame cropped, keyframe ATE < 0.6);
   ``subpixel`` (on one set of score maps, the card against the CPU: the
   same integer picks, refined keypoints within 1e-3 px; end to end, the
   kernels against the plain versions in float32 and bf16 at phase 5's
   overlap, in float32 also >= 0.9 of the common picks' refined keypoints
   within 1e-3 px, and the plain versions on the card against the CPU's,
   reported); ``patch`` (``superpoint_scratch_v2``, patch
   descriptors, matcher ``nn``, float32, a rendered plane through
   ``UR_MVO.process``: >= 4 keyframes, keyframe ATE < 0.45); ``snapshot``
   (session A over frames 0-15 of seed 11, ``save_map_snapshot``, every
   field back bit for bit from ``MapStore.load_snapshot``; session B a fresh
   engine, ``load_map_snapshot``, frames 16-23: initialised with no init
   attempt, a keyframe added, <= 6 frames lost, the keyframe ATE over both
   sessions beside the JAX package's, relocalizations; ``save_map_ply`` one
   vertex per good map point). The JAX package misses mono/3d's ATE gate on
   both protocols (``LOCAL_MAP_JAX``, ``SNAPSHOT_JAX``: fewer than 5 poses
   emitted with local-map tracking, keyframe ATE 0.348 over the two
   sessions), so those two are held to their health and print their ATE
   beside the JAX package's.
14. multi_seq: ``parallel/multi_seq.MultiSequenceVO`` (S sequences stepped
   lock-step, the device work of a frame batched across them). First each
   kernel at the lock-step batch against its single stream's launch, item
   by item bit for bit, and within phase 3's limits of its plain version:
   the stages at B = 3 (frame 0 of seeds 11-13) against B = 1, attention at
   B = 6 (three pairs) against B = 2, the transport of three lanes against
   each lane's call, pose GN at B = 6 (three lanes whose problems skip
   rounds differently) against B = 2. Then S = 3 lanes, the ``mono/3d``
   scenes of seeds 11-13 (24 frames each) with ``production_engine()``'s
   configuration under deterministic algorithms, launch counts reset just
   before: every lane that initialises held to phase 8's health limits,
   where a frame lost while the lane's reference keyframe held fewer than
   6 triangulated points (a collapsed map, which the JAX package's
   MultiSequenceVO shows too: ROADMAP C11) is counted apart, and a lane
   that never initialises reported; each lane's keyframe ATE and per-frame
   trace beside the single stream's (phase 8's runs) and the JAX package's
   (``MULTI_SEQ_JAX``); per lock-step frame one stage-kernel launch a
   stage, one attention launch a GNN layer, one Sinkhorn launch a lane
   (each again for every call a lane's view made at S = 1) and exactly one
   pose-GN launch for the batch where a lane tracks, plus one for every
   pose solve of the lanes' own flows (``Tracker.pose_calls``), with at
   least 0.3 of the tracking frames on which every tracking lane adopted
   its batched row. The same lanes rotated in the batch: each lane's trace
   and keyframe poses equal to its own above, and every batched track row
   equal bit for bit to the single-lane core's on its lane's inputs and
   draws. The same lanes through the plain
   versions (health printed, no kernel launched). Host ms a lock-step frame
   and frames a second over the lanes at S = 1 (seed 13), 3 and 6 (seeds
   11-16, 8 frames), and the device's busy and idle share of four profiled
   lock-step frames at S = 3.
15. mesh: the mesh paths of ``ur_mvo_tpu_torch.parallel`` in ranks of
   their own (this script with ``--mesh-rank``, the kernels built once by
   the parent first), world 1 over NCCL and world 2 over gloo with CUDA
   tensors (NCCL refuses two ranks on one GPU), both on ``cuda:0`` and both
   worlds at once, launch counts reset in each rank just before each path:
   ``MultiSequenceVO(mesh)`` on phase 14's lanes (world 1: the three; world
   2: the two that initialise, a lane a rank, each with its phase-14
   slot's generator), every lane's per-frame trace and keyframes bit for
   bit with phase 14's; ``make_batched_matcher`` on six pairs of those
   scenes, bit for bit with the unsharded batched match; phase 12's
   65,536-point problem through ``shard_problem`` and
   ``dist_bundle_adjust`` against ``bundle_adjust`` (phase 12's solution;
   phase 12 runs first) at phase 7's limits, and ``global_optimize(mesh)``
   on phase 9's long map against its ``global_optimize()``: reprojection
   RMS within 1%, keyframe ATE with and without scale correction at most
   twice the single device's, with it below the pose graph alone's (its
   bending mode moves the map far past phase 7's limits between any two
   routes); S = 3 on two ranks must raise; then ``cli.bench_scaling``'s
   count on its problem (32 frames, 8,192 points, 32,768 observations, 15
   LM steps): the ``all_reduce`` calls and bytes that ``mesh.all_sum``
   counted must be those its packed terms give (2 calls and 39,940 bytes a
   step, the JAX source's 5 ``psum`` calls printed beside them; no time is
   claimed). Each rank prints its launches and seconds a path; every rank
   must launch the stage kernels, attention, Sinkhorn and pose GN, and no
   shard's BA a point-reduce kernel. A rank that fails or outlives its
   deadline fails the phase.
16. sequence: ``UR_MVO.process_sequence`` with ``runtime.chunk_frames = 4``
   (``Tracker.process_chunk``: a block's device work queued at once, one
   readback, the host replaying the rows up to the first keyframe or weak
   row) on the ``mono/3d`` scenes of seeds 11-13 beside their per-frame
   runs, deterministic algorithms: the same keyframe frame ids, frames lost
   and init frame, phase 8's health, each seed's ATE and the means printed
   beside the per-frame ones (no gate: the chunk path is opt-in), the
   chunk's rows (queued, consumed, weak, discarded past a cut, cut where
   the carried pose was read and differed from the host's), host syncs a
   frame and host ms a frame of both paths (the sync counting on); the stage kernels, attention,
   Sinkhorn and pose GN must launch inside ``process_chunk``; ``stereo/3d``
   seed 11 chunked beside its per-frame run (the same keyframes, the
   keyframes that chunk rows inserted holding the per-frame run's gated
   right x); then the command line in-process: ``cli.make_synthetic_dataset``
   writes three 24-frame 240x320 ``3d`` sequences of ``.npy`` frames (the
   native prefetcher must read them), ``cli.run_vo`` runs one with
   shipped-matcher discovery and ``--gt``, frame by frame and with
   ``--chunk 4`` (its ATE line finite and under 0.35, the five main-path
   kernels launched), ``cli.run_vo_multi`` runs the three with the
   production operating point as a config (a lane must take >= 3
   keyframes); all of it under deterministic algorithms, and the host
   syncs counted with their ten busiest sites.
17. training: the stage kernel's ``torch.library`` op
   (``ur_mvo_tpu_torch::stage_conv``) in float32 at B = 16, 128x128 and
   B = 8, 256x320: the three stages forward within 1e-4 of the largest
   output of the plain versions, each stage's backward at the kernel
   path's stage inputs the plain version's autograd bit for bit, the
   gradients of a fixed random projection of the chain's output with
   respect to the input and the six weights and biases within 1e-2
   (relative L2) of the all-plain chain's (deterministic, no TF32), 3
   launches a backbone call and none in the backward; attention, Sinkhorn (and the dustbin transport), pose GN and
   both point reductions called on CUDA inputs that require grad under grad
   mode must raise (and run under ``torch.no_grad()``);
   ``models.pretrain_superpoint.pretrain`` at full width (B = 16, 128x128,
   the NCE descriptor term, seed 0, 60 steps at lr 2e-3) held to
   ``tests/test_pretrain.py``'s gate on a fresh batch (detector loss < 0.85
   x an untrained network's, corner cells' peak scores >= 1.3 x the
   background's), 9 stage-kernel launches a step; 20 fine-tuning steps
   (``train_superpoint``, the descriptor head of the shipped detector,
   rendered 256x320 frames, B = 8): a held-out batch's loss falls, only
   convDa / convDb change bits, 6 launches a step; 20 steps of
   ``train_superglue.train_on_device`` at ``train_superglue.py``'s defaults
   (9 layers, 4 heads, capacity 256, 640x512, B = 8; ``kernels=False``):
   a held-out batch's loss falls, no kernel launched; the data-parallel step
   (``parallel.train_step``) in ranks of their own (this script with
   ``--train-rank``; world 1 over NCCL, world 2 over gloo with CUDA
   tensors, both at once, on a batch of 4 warped pairs of rendered 256x320
   frames): world 1 bit for bit with the single step, world 2 within
   rtol 1e-5 of the whole batch's loss and 1e-5 of its largest gradient,
   the replicas bit for bit; the frame step at 240x320 with the shipped
   weights exported (``models.export``), saved, reloaded and run: 6
   ``stage_conv`` nodes, outputs equal to the eager step's, the stage
   kernel launched 6 times (3 an image), keypoints and matches against a
   float32 ``NeuralExtractor``'s extract and match at phases 4-5's
   thresholds (overlap >= 0.95, agreement >= 0.90). Seconds a step of each
   trainer, the export's trace, load and run times.
18. matrix (three processes of its own, ``--matrix-side DIR
   mono|metric|long``, started with phase 10's and joined after it: their
   lines print then): the accuracy
   matrix through its command line, ``cli.bench_accuracy.main`` (the port
   of ``scripts/bench_accuracy.py``, which takes deterministic algorithms on
   CUDA itself), launch counts per cell and matcher: (a) the seven short
   cells, ``mono/plane,mono/3d,mono/decay`` with ``nn,sg`` and
   ``stereo/3d,stereo/decay,rgbd/3d,rgbd/decay`` with ``nn,hybrid``, seeds
   11-13, 24 frames, each part into its own ``build/matrix/<part>.json``;
   each
   production column held to the gate of
   ``tests/test_accuracy_gates.py::test_production_cell_zero_failures_and_bounded``
   (no failed seed, mean under the cell's bound: ``mono/plane`` 0.12,
   ``mono/3d`` 0.15, ``mono/decay`` 0.45, ``stereo/3d`` 0.60,
   ``stereo/decay`` 0.65, ``rgbd/3d`` 0.15, ``rgbd/decay`` 0.25) and each
   of its runs to phase 8's health (initialised, >= 3 keyframes, <= 6 frames
   lost), the frames lost while the run's reference keyframe held fewer
   than 6 triangulated points counted apart, as phase 14 counts them (a
   collapsed map after a one-inlier frame became a keyframe, which the JAX
   package shows on the same scenes: ROADMAP C11, C17); every ``sg`` / ``hybrid`` column must launch the stage kernels,
   attention, Sinkhorn and pose GN, every ``nn`` column the stage kernels
   and pose GN and never attention or Sinkhorn (it loads no SuperGlue
   weights); the table of cells (mean, spread, failed, runs, host ms a
   frame) beside ``ACCURACY.json``'s means (the JAX package on the CPU),
   and production mean over ``nn`` mean beside the JAX rule's 1.10, a
   reading; (b) each seed's ATE of the three ``3d`` cells equal to the
   digit (the CLI's four) to phase 8's kernel run (``mono/3d``) and phase
   10's (``stereo/3d``, ``rgbd/3d``), where those phases ran; (c)
   ``--long --cells mono/long --matchers sg --seeds 1``: seed 11's online
   ATE and its ATE after ``global_optimize`` equal to phase 9's to the
   digit; (d) the shipped stereo checkpoint on
   ``tests/test_shipped_superglue_stereo.py``'s protocol (the plane scene
   of ``cli.make_synthetic_dataset.render_plane_sequence`` with a
   radtan-distorted right lens, k1 -0.28, k2 0.07, baseline 0.1, seed 0,
   24 frames at 240x320, the right camera's rectify map from that lens,
   ``superglue_v4stereo.npz``, deterministic algorithms): initialised,
   >= 3 keyframes, keyframe ATE (scale-corrected) finite and under 0.6,
   every kernel launched. The phase's seconds beside its budget of 150.

Then each phase's seconds, the ``kernels`` line (launches from the engine
run; the sorted reduction's from the long map's ``global_optimize``, the
unsorted one's from the ``"pallas"`` global BA; times at the global
shape; ``launches_by_path``: each path's own counts, ``mono/long`` with the
long map's ``global_optimize``, phase 13's paths, ``local_map_step``
the local-map steps' own ``pose_gn`` launches, phase 14's
``multi_seq``, phase 15's ``mesh/w1``, ``mesh/w2/r0``, ``mesh/w2/r1``:
each rank's lanes and match, phase 16's ``chunk`` (inside
``process_chunk``) and ``cli/run_vo``, ``cli/run_vo_chunk``,
``cli/run_vo_multi``, and phase 17's ``train/pretrain``,
``train/finetune``, ``train/superglue``, ``train/export`` (the reloaded
program's run) and ``train/dp/w1``, ``train/dp/w2/r0``, ``train/dp/w2/r1``,
and phase 18's ``matrix/<setup>/<scene>/<matcher>``, ``matrix/mono/long/sg``
and ``matrix/v4stereo``), the ``nvidia-smi`` name/power-limit line,
and as the last line ``{"ok": true, "device": {...}}``. A failed check prints a
``{"phase": ..., "failed": ...}`` line and the run goes on to the next
phase; at the end any failure makes the exit code 1 and leaves the
``kernels`` and last lines out. An error that is not a check raises. Without CUDA it exits
with code 2 before doing anything. ``--only-pose-gn`` builds, checks the
pose-GN kernel and stops: the short first run after an edit to it.
``--engine-seeds 0,11,12 [--repeats N] [--deterministic] [--scene plane|decay]``
builds and runs the engine N times on each of those scenes of the mono/3d
family (or another mono cell's; and once on the plain versions),
printing each run's keyframes, frames lost (and at which frames), the fused
step's matches and inliers a frame, and ATE: the spread from one run
to the next. ``--swap stage_conv,attention,sinkhorn,pose_gn`` adds a run
with each named kernel alone on its plain version (``plain_<name>``),
``--only ...`` a run with each named kernel alone left on (``only_<name>``),
and ``--audit`` holds every call of the first kernel run against the plain
version on the same inputs (each kernel's largest error, pose GN's inlier
counts, the matches Sinkhorn's and the whole matcher's scores decode to):
the bisect of a kernel run that fares unlike its plain run.
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
``--only-extras`` builds and runs phase 13 alone; ``--only-multi-seq``
phase 14; ``--only-mesh`` phase 15 (with phase 14's S = 3 run and phase
9's long map for its references); ``--only-sequence`` phase 16 (with its
own per-frame runs); ``--only-training`` phase 17; ``--only-matrix`` phase
18 (in this process; without phases 8-10 its 3d cells and seed 11 of
``mono/long`` are printed alone); ``--deterministic-witness`` names the
ops that deterministic algorithms flag on ``mono/3d`` seed 11 (the first
to raise without ``warn_only``, every warning with it) and times host ms a
frame on seeds 11-13 with the setting off and on in turns;
``--multi-seq-witness`` phase 14's lanes under the variants of
``multi_seq_witness`` (float32, other samplers, each lane alone, other
scenes), a per-frame trace a lane.
``--metric-seeds rgbd/long 11,12,...,20 [--plain] [--float32-point-side]``
runs one metric protocol on those scenes through phase 10's code, printing
each run's ATE (the spread behind its 3-seed gate) and the gate over all of
them; ``--float32-point-side`` sums the stereo and RGB-D BAs' point side
of exact float32 summands, as the monocular setup does.
``--ptxas`` prints registers and shared memory per kernel.
"""

from __future__ import annotations

import collections
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
# the metric protocols of scripts/bench_accuracy.py with matcher hybrid:
# stereo/3d and rgbd/3d as mono/3d above (a 0.12 m baseline for stereo), and
# rgbd/long as mono/long; ATE without scale correction. Gates of
# tests/test_accuracy_gates.py: no failed seed, mean ATE under the bound
# (rgbd/long: online and after global optimization)
BASELINE_M = 0.12
METRIC_MAX_ATE = {"stereo/3d": 0.60, "rgbd/3d": 0.15}
RGBD_LONG_MAX_ONLINE, RGBD_LONG_MAX_PGO = 0.30, 0.25

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
# phase 13: the extraction bucket held against the native 240x320 extraction
# (tests/test_resolution_buckets.py's), and the engine pass through a
# (240, 320) bucket with every third frame cropped (16 frames, keyframe ATE
# under 0.6, as that test); the from-scratch patch-descriptor pipeline of
# tests/test_patch_desc.py (24 frames, >= 4 keyframes, keyframe ATE under
# 0.45); the snapshot protocol's split of the 24-frame scene and its gate
EXTRAS_BUCKET = (288, 384)
BUCKET_FRAMES, BUCKET_MAX_ATE = 16, 0.6
PATCH_WEIGHTS = os.path.join(REPO, "weights", "superpoint_scratch_v2.npz")
PATCH_FRAMES, PATCH_MIN_KEYFRAMES, PATCH_MAX_ATE = 24, 4, 0.45
SNAPSHOT_SPLIT = 16
# the JAX package on phase 13's local-map and snapshot protocols, on the CPU
# (scripts/metric_gauge.py --reference mono/3d+local_map 11,12,13 and
# --reference snapshot 11): printed beside the port's runs
LOCAL_MAP_JAX = {
    11: {"ate": None, "poses_emitted": 1, "keyframe_ate": 0.1640, "keyframes": 7, "frames_lost": 0},
    12: {"ate": None, "poses_emitted": 1, "keyframe_ate": 0.1533, "keyframes": 7, "frames_lost": 0},
    13: {"ate": None, "poses_emitted": 1, "keyframe_ate": 0.1063, "keyframes": 5, "frames_lost": 0},
}
SNAPSHOT_JAX = {"seed": 11, "keyframes_a": 5, "keyframes_after_b": 8, "keyframe_ate_both_sessions": 0.3480,
                "frames_lost_b": 0, "relocalizations_b": 0}
# phase 14: the frames of the S = 6 timing run (seeds 11-16); the least
# share of the S = 3 run's tracking frames on which every tracking lane
# adopts its batched row (7 of 20 on this slice's first card runs: a lane
# whose map collapsed falls back on every frame, ROADMAP C11); and the
# JAX package's MultiSequenceVO on the same lanes, on the CPU
# (scripts/metric_gauge.py --reference multi_seq 11,12,13), printed beside
# the port's lanes. Its lanes 11 and 12 never initialise in 24 frames (its
# batched match has no init-only NN floor), so it has no 3-lane mean: the
# lanes are held to phase 8's health only (ROADMAP C11)
MULTI_SEQ_S6_FRAMES = 8
MULTI_SEQ_MIN_CLEAN_SHARE = 0.3
# fewer triangulated points than the PnP minimum (DLT, 6) in a lane's
# reference keyframe: a collapsed map (multi_seq_health)
MULTI_SEQ_COLLAPSED = 6
MULTI_SEQ_JAX = {
    11: {"initialised_at_frame": None, "keyframes": 0, "keyframe_ate": None, "frames_lost": 0},
    12: {"initialised_at_frame": None, "keyframes": 0, "keyframe_ate": None, "frames_lost": 0},
    13: {"initialised_at_frame": 3, "keyframes": 6, "keyframe_ate": 0.1059, "keyframe_poses_returned": 1,
         "frames_lost": 0},
}
# phase 8's runs, for phase 14's comparison
SINGLE_STREAM_ROWS: list = []
# phase 15: each world (ranks, backend, the phase-14 slots of its lanes:
# world 2 takes the two lanes that initialise, so that both ranks track),
# each check's rank-side seconds and the deadline of a world's ranks;
# phase 14's S = 3 lanes (traces, keyframes) and phase 9's long map
# (store, backend configuration, ``global_optimize()``'s result) and
# phase 12's ``"auto"`` solution, filled where those phases ran
MESH_WORLDS = ((1, "nccl", (0, 1, 2)), (2, "gloo", (1, 2)))
MESH_DEVICE = "cuda:0"
MESH_DEADLINE_S = 240
# phase 17: pretraining (pretrain_superpoint.py's default 128x128, the CLI's
# batch of 16), the fine-tuning crop (train_superpoint.py's 256x320, batch 8),
# SuperGlue training at train_superglue.py's defaults (9 layers, 4 heads,
# capacity 256, 640x512, batch 8)
PRETRAIN_SHAPE = (16, 128, 128)
PRETRAIN_STEPS = 60
PRETRAIN_LR = 2e-3  # tests/test_pretrain.py's
TRAIN_CROP = (256, 320)
FINETUNE_BATCH = 8
FINETUNE_STEPS = 20
SG_TRAIN = dict(batch=8, capacity=256, width=640, height=512, num_layers=9, num_heads=4)
SG_STEPS, SG_CHUNK = 20, 10
TRAIN_DEADLINE_S = 150
MULTI_SEQ_REF: dict = {}
LONG_MAP_REF: dict = {}
GLOBAL_BA_REF: dict = {}
# phase 9's runs and phase 10's kernel runs' ATE by protocol and seed, for
# phase 18's comparison
LONG_ROWS: list = []
METRIC_ATES: dict = {}
# phase 18: the short matrix as two calls of cli.bench_accuracy (cells,
# matchers), seeds 11-13, 24 frames
MATRIX_CALLS = (("mono/plane,mono/3d,mono/decay", "nn,sg"),
                ("stereo/3d,stereo/decay,rgbd/3d,rgbd/decay", "nn,hybrid"))
# each cell's production matcher and bound: the gate of
# tests/test_accuracy_gates.py::test_production_cell_zero_failures_and_bounded
# (its PRODUCTION, lines 36-44): no failed seed, mean under the bound
MATRIX_PRODUCTION = {
    "mono/plane": ("sg", 0.12), "mono/3d": ("sg", 0.15), "mono/decay": ("sg", 0.45),
    "stereo/3d": ("hybrid", 0.60), "stereo/decay": ("hybrid", 0.65),
    "rgbd/3d": ("hybrid", 0.15), "rgbd/decay": ("hybrid", 0.25),
}
# test_production_matcher_is_the_measured_winner's rule (production mean <=
# 1.10 x the nn mean), printed here as a reading
MATRIX_WINNER_RATIO = 1.10
# an nn column loads no SuperGlue weights: it launches the stages and pose GN,
# and never attention or Sinkhorn
NN_KERNELS = ("stage1_conv", "stage_conv", "pose_gn")
NN_ABSENT = ("attention", "sinkhorn")
# tests/test_shipped_superglue_stereo.py's protocol for the shipped stereo
# checkpoint: the plane scene with a radtan-distorted right lens, baseline
# 0.1 m, seed 0, 24 frames at 240x320; initialised, >= 3 keyframes,
# keyframe ATE (scale-corrected) finite and under 0.6
V4STEREO_WEIGHTS = os.path.join(REPO, "weights", "superglue_v4stereo.npz")
V4STEREO = dict(frames=24, baseline=0.1, d_right=(-0.28, 0.07, 0.0, 0.0), seed=0, max_ate=0.6)
# phase 18's process: its budget (printed beside its seconds) and the
# deadline after which the parent kills it
MATRIX_BUDGET_S = 150
MATRIX_DEADLINE_S = 450
# its three parts, each in a process of its own in the whole run: the mono
# cells, the stereo and RGB-D cells with the stereo checkpoint, and
# mono/long; each writes its own file, MATRIX_DIR/<part>.json
MATRIX_PARTS = ("mono", "metric", "long")
MATRIX_DIR = os.path.join(REPO, "build", "matrix")



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


def attention_mask_witness(fn, control: bool = False):
    """The mask dtype each call of the extension's attention binding gets
    while ``fn`` runs, and for each call the bool -> uint8 conversions
    dispatched since the previous one (its own included), from a
    ``TorchDispatchMode`` that sees every aten op of the thread, those the
    binding would issue too. Unlike the profiler, it drops nothing.
    ``control`` casts the mask to uint8 right before each call (the wrapper
    as it was before the bool mask), which must show in both readings."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from ur_mvo_tpu_torch.ops import cuda_ext

    ext = cuda_ext.extension()
    launch = ext.attention
    dtypes, casts, pending = [], [], [0]

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = {t.dtype for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)}
            outs = {t.dtype for t in tree_leaves(out) if isinstance(t, torch.Tensor)}
            pending[0] += torch.bool in ins and torch.uint8 in outs
            return out

    def logged(q, k, v, kv_valid, *rest):
        if control:
            kv_valid = kv_valid.to(torch.uint8)
        dtypes.append(str(kv_valid.dtype))
        out = launch(q, k, v, kv_valid, *rest)
        casts.append(pending[0])
        pending[0] = 0
        return out

    ext.attention = logged
    try:
        with Log():
            fn()
    finally:
        ext.attention = launch
    return dtypes, casts


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
    # frozen: the stage op records no gradient graph for these checks
    return sp.to(device="cuda", dtype=torch.bfloat16).requires_grad_(False)


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
# Phase 11: the two BA point-reduce kernels against their plain versions
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
# Phase 9: the long protocol (relocalization, loop closure, global BA)
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
    LONG_MAP_REF.update(store=st, order=order, used=used, t_true=t_true, ate_before=row["ate_before"],
                        ate_after=row["kernels"]["ate_after"],
                        template=(template.camera, template.cfg, template.opt_cfg),
                        kernels={f: getattr(k, f).copy() for f in ("kf_R", "kf_t", "mp_pos")})
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
    ``global_optimize()`` and the ATE of the keyframe trajectory after it
    (with scale correction for mono, without it for a metric setup)."""
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
    online = emitted_ate(stamps, poses, T_wc, needs_scale(vo))
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
    row["pgo_ate"] = float(ate_rmse(np.asarray(kpos), T_wc[kidx][:, :3, 3], align=True, correct_scale=needs_scale(vo)))
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
    LONG_ROWS[:] = rows
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
# Phase 10: the metric setups (stereo, RGB-D) with the hybrid matcher
# ---------------------------------------------------------------------------

def metric_scene(protocol, seed):
    """The frames (stereo: with the right image; RGB-D: with the rendered
    metric depth) and true poses of one scene of a metric protocol."""
    from ur_mvo_tpu_torch.components import DepthMap, Frame, Image
    from ur_mvo_tpu_torch.utils.synthscene import out_and_back_trajectory, render_sequence

    setup, cell = protocol.split("/")
    if cell == "long":
        n, h, w, fx, poses = LONG_FRAMES, LONG_H, LONG_W, LONG_FX, out_and_back_trajectory(LONG_FRAMES)
    else:
        n, h, w, fx, poses = ENGINE_FRAMES, H, W, FX, None
    out = render_sequence(n, h, w, fx, seed=seed, n_planes=3, z_background=6.0, poses=poses,
                          baseline=BASELINE_M if setup == "stereo" else 0.0)
    frames = []
    for i in range(n):
        f = Frame(image=Image(out[0][i], i / FPS))
        if setup == "stereo":
            f.right_image = Image(out[3][i], i / FPS)
        else:
            f.depth_map = DepthMap(out[2][i])
        frames.append(f)
    return frames, out[1]


def metric_config(protocol):
    """A metric protocol's configuration: ``production_config`` with
    matcher ``hybrid`` (the init-only NN floor of 40, relocalization on;
    ``*/long``: its long-run configuration)."""
    return production_config(long_run=protocol.split("/")[1] == "long", matcher="hybrid")


def metric_engine(protocol, kernels=True, device="cuda", float32_point_side=False):
    """``UR_MVO`` for a metric protocol with ``metric_config``, and for
    stereo a camera whose bf is fx times the baseline. ``float32_point_side``
    swaps in a backend whose BAs sum the point side of exact float32
    summands, as the monocular setup's do, where the stereo and RGB-D
    setups' round them to bf16 (a measurement, ``--metric-seeds``)."""
    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.config import SensorSetup
    from ur_mvo_tpu_torch.engine import UR_MVO
    from ur_mvo_tpu_torch.runtime.backend import Backend

    setup, cell = protocol.split("/")
    w, h, fx = (LONG_W, LONG_H, LONG_FX) if cell == "long" else (W, H, FX)
    cfg = metric_config(protocol)
    cam = make_pinhole(w, h, fx, fx, w / 2, h / 2, bf=fx * BASELINE_M if setup == "stereo" else 0.0)
    vo = UR_MVO(cfg, SensorSetup(setup), camera=cam, device=device, kernels=kernels)
    if float32_point_side:
        vo.tracker.backend = Backend(cam, cfg.backend, cfg.backend_optimization,
                                     keypoints_per_frame=cfg.superpoint.capacity, device=device, kernels=kernels)
    return vo


class MetricProbe:
    """What a metric run went through, read without a host sync on its
    path: the init function that fired (the tracker's ``_init_stereo`` /
    ``_init_rgbd`` wrapped on this engine), and the rows of each pose-GN
    problem of the tracking steps (``frontend.optimize_pose`` wrapped):
    valid rows and stereo rows (u_right > 0), summed on the device."""

    def __init__(self, vo):
        import torch

        from ur_mvo_tpu_torch.runtime import frontend

        self.frontend, self.inits = frontend, []
        self.rows = torch.zeros(2, dtype=torch.int64, device="cuda")
        self.problems = 0
        self.optimize_pose = frontend.optimize_pose
        tracker = vo.tracker
        for name in ("_init_stereo", "_init_rgbd"):
            setattr(tracker, name, self._init_wrapper(name, getattr(tracker, name)))

        def counted(R0, t0, obs, *args, **kw):
            valid = obs.valid.reshape(-1, obs.valid.shape[-1])
            stereo = valid & (obs.uv.reshape(valid.shape + (3,))[..., 2] > 0)
            self.rows += torch.stack([valid.sum(), stereo.sum()])
            self.problems += valid.shape[0]
            return self.optimize_pose(R0, t0, obs, *args, **kw)

        frontend.optimize_pose = counted

    def _init_wrapper(self, name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if out is not None:
                self.inits.append(name)
            return out

        return wrapped

    def read(self):
        """(init functions that fired, pose-GN problems, mean valid rows and
        mean stereo rows a problem) since the last read."""
        valid, stereo = self.rows.tolist()
        out = (self.inits, self.problems, valid / max(self.problems, 1), stereo / max(self.problems, 1))
        self.inits, self.problems = [], 0
        self.rows.zero_()
        return out

    def close(self):
        self.frontend.optimize_pose = self.optimize_pose


def metric_runs(protocol, kernels, scenes, smi, float32_point_side=False):
    """A 24-frame metric protocol on the kernels or their plain versions
    over ``scenes`` (seed -> scene), launch counts reset just before: per
    seed the run's health, ATE and what the probe saw."""
    import torch

    from ur_mvo_tpu_torch.ops import cuda_ext, cuda_pose

    vo = metric_engine(protocol, kernels, float32_point_side=float32_point_side)
    probe = MetricProbe(vo)
    cuda_ext.LAUNCHES.clear()
    cuda_pose.reset_steps()
    rows = []
    try:
        for seed, scene in scenes.items():
            row, per_frame, _ = engine_run(vo, seed, scene)
            inits, problems, valid, stereo = probe.read()
            row.update({"init": inits, "pose_gn_problems": problems, "valid_rows_a_problem": valid,
                        "stereo_rows_a_problem": stereo, "host_ms_a_frame_median": statistics.median(per_frame)})
            rows.append(row)
    finally:
        probe.close()
    launches = dict(cuda_ext.LAUNCHES)
    steps, problems = cuda_pose.steps_run()
    mean = statistics.mean(r["ate"] if r["ate"] is not None else float("nan") for r in rows)
    emit({"phase": "metric", "protocol": protocol, "path": "kernels" if kernels else "plain",
          "float32_point_side": float32_point_side, "frames": ENGINE_FRAMES, "seeds": list(scenes), "runs": rows,
          "tracked_frames": vo.tracker.timer.summary().get("track", {}).get("count", 0), "mean_ate": mean,
          "max_ate": METRIC_MAX_ATE[protocol], "launches": launches,
          "pose_gn_mean_steps": steps / max(problems, 1), "card": smi})
    vo.shutdown()
    torch.cuda.synchronize()
    return rows, launches


def metric_check(protocol, rows, what, launches=None):
    """The protocol's gate of ``tests/test_accuracy_gates.py`` (no failed
    seed, mean ATE under the bound) and the health of each run: the setup's
    own init fired; on the kernels every kernel of the path launched."""
    setup = protocol.split("/")[0]
    gate = METRIC_MAX_ATE[protocol]
    mean = check_engine_runs(rows, f"{protocol}, {what}", max_lost=MAX_FRAMES_LOST if launches is not None else None,
                             max_ate=gate)
    if not mean < gate:
        raise AssertionError(f"{protocol} ({what}): mean ATE {mean} (< {gate})")
    for r in rows:
        if r["init"] != [f"_init_{setup}"]:
            raise AssertionError(f"{protocol} ({what}, seed {r['seed']}): init {r['init']}, not _init_{setup}")
    if launches is not None:
        missing = [k for k in ENGINE_KERNELS if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"{protocol}: kernels of the path never launched: {missing}")
    return mean


def rgbd_long(smi, seeds=ENGINE_SEEDS, kernels=True, float32_point_side=False):
    """``scripts/bench_accuracy.py --long`` for ``rgbd/long`` with matcher
    ``hybrid`` on the kernels (or their plain versions), launch counts
    reset just before: per seed the online ATE, ``global_optimize()`` and
    the ATE after it (both without scale correction), the init that fired,
    and the full BA's size and resolved assembly (``"auto"``: ``"scatter"``
    below 128M indicator elements, ``"sorted"`` above)."""
    from ur_mvo_tpu_torch.ops import cuda_ext

    protocol = "rgbd/long"
    vo = metric_engine(protocol, kernels, float32_point_side=float32_point_side)
    probe = MetricProbe(vo)
    cuda_ext.LAUNCHES.clear()
    rows = []
    try:
        for seed in seeds:
            row = long_run(vo, seed, metric_scene(protocol, seed))
            row["init"] = probe.read()[0]
            rows.append(row)
            emit({"phase": "metric", "protocol": protocol, "path": "kernels" if kernels else "plain",
                  "float32_point_side": float32_point_side, **row})
    finally:
        probe.close()
    launches = dict(cuda_ext.LAUNCHES)
    vo.shutdown()
    failed = [r["seed"] for r in rows if r["online_ate"] is None]
    online = statistics.mean(r["online_ate"] for r in rows if r["online_ate"] is not None) if len(failed) < len(rows) else None
    pgo = statistics.mean(r["pgo_ate"] for r in rows)
    full_ba = {r["seed"]: r["full_ba"] for r in rows}
    emit({"phase": "metric_summary", "protocol": protocol, "seeds": list(seeds), "frames": LONG_FRAMES,
          "size": [LONG_H, LONG_W], "online_mean_ate": online, "pgo_mean_ate": pgo, "failed_seeds": failed,
          "gate": {"online": RGBD_LONG_MAX_ONLINE, "pgo": RGBD_LONG_MAX_PGO}, "full_ba": full_ba,
          "full_ba_past_the_128M_line": [s for s, f in full_ba.items() if f and f["assembly"] == "sorted"],
          "launches": launches, "card": smi})
    if failed:
        raise AssertionError(f"{protocol}: seeds {failed} emitted fewer than 5 poses (failed runs)")
    if not (online < RGBD_LONG_MAX_ONLINE and pgo < RGBD_LONG_MAX_PGO):
        raise AssertionError(f"{protocol}: online mean ATE {online} (< {RGBD_LONG_MAX_ONLINE}), after global "
                             f"optimization {pgo} (< {RGBD_LONG_MAX_PGO})")
    for r in rows:
        if r["init"] != ["_init_rgbd"]:
            raise AssertionError(f"{protocol} (seed {r['seed']}): init {r['init']}, not _init_rgbd")
        if r["full_ba"] is None:
            raise AssertionError(f"{protocol} (seed {r['seed']}): global_optimize ran no full BA")
    missing = [k for k in ENGINE_KERNELS if launches.get(k, 0) == 0]
    if kernels and missing:
        raise AssertionError(f"{protocol}: kernels of the path never launched: {missing}")
    return launches


def metric_seeds(protocol, seeds, kernels=True, float32_point_side=False):
    """One metric protocol over more scene seeds than its gate's three
    (``--metric-seeds``), under deterministic algorithms: the seed-to-seed
    spread a 3-seed gate has to stand. ``float32_point_side`` gives the
    stereo and RGB-D BAs the exact float32 point side of the monocular
    setup in place of the JAX package's bf16 one."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    if protocol == "rgbd/long":
        return rgbd_long(None, seeds, kernels, float32_point_side)
    rows, _ = metric_runs(protocol, kernels, {s: metric_scene(protocol, s) for s in seeds}, None, float32_point_side)
    return metric_check(protocol, rows, "kernels" if kernels else "plain versions")


def metric_phase(smi):
    """``stereo/3d`` and ``rgbd/3d`` on the kernels and on their plain
    versions, then ``rgbd/long`` on the kernels, under PyTorch's
    deterministic algorithms. Pose GN must be fed stereo rows on
    ``stereo/3d``. Returns each protocol's launch counts on the kernels and
    the 24-frame protocols' ATE by seed on the kernels."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    launches, ates = {}, {}
    for protocol in METRIC_MAX_ATE:
        scenes = {seed: metric_scene(protocol, seed) for seed in ENGINE_SEEDS}
        rows, launches[protocol] = metric_runs(protocol, True, scenes, smi)
        ates[protocol] = {r["seed"]: r["ate"] for r in rows}
        plain_rows, plain_launches = metric_runs(protocol, False, scenes, smi)
        emit({"phase": "metric_summary", "protocol": protocol, "max_ate": METRIC_MAX_ATE[protocol],
              "mean_ate": {"kernels": statistics.mean(r["ate"] or float("nan") for r in rows),
                           "plain": statistics.mean(r["ate"] or float("nan") for r in plain_rows)}})
        metric_check(protocol, rows, "kernels", launches[protocol])
        if plain_launches:
            raise AssertionError(f"{protocol} with kernels=False launched kernels: {plain_launches}")
        metric_check(protocol, plain_rows, "plain versions")
        if protocol.startswith("stereo") and not min(r["stereo_rows_a_problem"] for r in rows) > 0:
            raise AssertionError(f"{protocol}: a run fed pose GN no stereo row")
    launches["rgbd/long"] = rgbd_long(smi)
    return launches, ates


# phase 10 runs in a process of its own beside phases 9 and 13 (the three
# are host-bound and share nothing), so that the script stays well inside
# its time limit on a slow host; the deadline of that process
METRIC_DEADLINE_S = 700


def metric_side(workdir):
    """``--metric-side DIR``: phase 10 in a process of its own, its result
    (launches and ATEs, or the failure) pickled to ``DIR/side.pkl``. The
    parent built the extension; this process loads it."""
    import pickle

    from ur_mvo_tpu_torch.ops import cuda_ext

    cuda_ext.extension()
    t0 = time.perf_counter()
    try:
        launches, ates = metric_phase(nvidia_smi_line())
        out = {"launches": launches, "ates": ates}
    except AssertionError as e:
        out = {"failed": str(e)}
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(workdir, "side.pkl"), "wb") as f:
        pickle.dump(out, f)


def start_side(flag, name, deadline_s, *extra):
    """Start this script with ``flag build/{name} [extra]`` in a process of
    its own (phase 10's ``--metric-side``, phase 18's ``--matrix-side``);
    its output goes to ``build/{name}/side.log`` until :func:`join_side`."""
    import shutil

    workdir = os.path.join(REPO, "build", name)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    log = open(os.path.join(workdir, "side.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, workdir, *extra], cwd=REPO,
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log, workdir, time.monotonic() + deadline_s, name, deadline_s


def join_side(side):
    """Wait for a process of :func:`start_side` (killed past its deadline),
    print its JSON lines, and return what it pickled; a crash or the
    deadline fails the phase."""
    import pickle

    proc, log, workdir, deadline, name, deadline_s = side
    try:
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    with open(os.path.join(workdir, "side.log")) as f:
        text = f.read()
    for line in text.splitlines():
        if line.startswith("{"):
            print(line, flush=True)
    if proc.returncode != 0:
        print(f"--- the {name} phase's process (exit {proc.returncode}), the end of its output:\n{text[-3000:]}",
              file=sys.stderr, flush=True)
        raise AssertionError(f"{name}: its process exited {proc.returncode} (deadline {deadline_s} s)")
    with open(os.path.join(workdir, "side.pkl"), "rb") as f:
        return pickle.load(f)


def join_metric_side(side):
    """Phase 10's process joined: its launches (its ATEs kept for phase
    18); its failure fails the phase."""
    out = join_side(side)
    emit({"phase": "metric", "check": "seconds", "in_its_process": out["seconds"]})
    if "failed" in out:
        raise AssertionError(out["failed"])
    METRIC_ATES.update(out["ates"])
    return out["launches"]


def start_matrix_sides():
    """Phase 18's parts (``MATRIX_PARTS``), each in a process of its own,
    each writing its own file in ``MATRIX_DIR``."""
    import shutil

    shutil.rmtree(MATRIX_DIR, ignore_errors=True)
    os.makedirs(MATRIX_DIR)
    return [start_side("--matrix-side", f"matrix/{part}", MATRIX_DEADLINE_S, part) for part in MATRIX_PARTS]


def join_matrix_sides(sides, smi):
    """Phase 18's processes joined (every one, also after a failure) and
    checked against phases 8-10 (:func:`matrix_check`)."""
    outs, bad = [], []
    for side in sides:
        try:
            out = join_side(side)
        except AssertionError as e:
            bad.append(str(e))
            continue
        if "error" in out:
            print(out["error"], file=sys.stderr, flush=True)
            bad.append(f"matrix ({out['part']}): its process raised: " + out["error"].strip().splitlines()[-1])
            continue
        outs.append(out)
    if bad:
        raise AssertionError("; ".join(bad))
    return matrix_check(outs, smi)


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
    GLOBAL_BA_REF.update(result=runs["auto"], seconds=launches["auto"]["host_ms"] / 1e3)
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

    # the wrapper passes the bool mask as it is: every attention call of a
    # match must get a bool mask with no bool -> uint8 conversion dispatched
    # since the call before it (attention_mask_witness), and the control,
    # which casts before each call, must show in both readings
    cuda_ext.LAUNCHES.clear()
    dtypes, casts = attention_mask_witness(lambda: ext.match(banks[0], banks[1]))
    n_calls = cuda_ext.LAUNCHES["attention"]
    c_dtypes, c_casts = attention_mask_witness(lambda: ext.match(banks[0], banks[1]), control=True)
    # the device kernel before each attention launch of three matches, from
    # the profiler, beside the kernel of a bool -> uint8 cast profiled on its
    # own (reported, not gated: the profiler may drop or misplace records)
    cast = set(device_kernels(lambda: [banks[0].valid.to(torch.uint8) for _ in range(20)]))
    names = device_kernels(lambda: [ext.match(banks[0], banks[1]) for _ in range(3)])
    n_kernels = sum("attention_mma_kernel" in n for n in names)
    before = [names[i - 1] for i, n in enumerate(names) if "attention_mma_kernel" in n and i > 0]
    emit({"phase": "device_share", "what": "match_attention", "attention_calls": n_calls,
          "mask_dtypes": {d: dtypes.count(d) for d in set(dtypes)}, "casts_before_attention": sum(casts),
          "control_mask_dtypes": {d: c_dtypes.count(d) for d in set(c_dtypes)},
          "control_calls_with_a_cast": sum(c > 0 for c in c_casts),
          "profiler": {"attention_kernels_of_3_matches": n_kernels, "cast_kernel": [c[:70] for c in cast],
                       "before_attention": {k[:70]: before.count(k) for k in set(before)},
                       "casts_before_attention": sum(n in cast for n in before)}})
    if not n_calls or len(dtypes) != n_calls or set(dtypes) != {"torch.bool"} or any(casts):
        raise AssertionError(f"a match's attention calls: {n_calls} launched, {len(dtypes)} seen, mask dtypes "
                             f"{set(dtypes)}, bool -> uint8 conversions before each {casts}")
    if len(c_dtypes) != n_calls or set(c_dtypes) != {"torch.uint8"} or not all(c_casts):
        raise AssertionError(f"the mask witness misses a cast before each call: {c_dtypes} {c_casts}")
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

def production_config(long_run=False, matcher="sg"):
    """The production configuration of ``cli.bench_accuracy`` (the port of
    ``scripts/bench_accuracy.py``'s ``_production_cfg``; matcher ``sg``
    unless another is named): the checkpoint's operating point, the
    init-only NN floor of 40, relocalization on. ``long_run``: its
    long-sequence configuration at 480x640, with culling, loop closure and
    the tracking-time NN floor of 40 on too.
    ``tests/test_torch_bench_accuracy.py`` holds it field for field to the
    JAX script's."""
    from ur_mvo_tpu_torch.cli.bench_accuracy import production_cfg

    w, h = (LONG_W, LONG_H) if long_run else (W, H)
    return production_cfg(matcher, W=w, H=h, long_run=long_run)


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


def needs_scale(vo):
    """Only the monocular setup lacks metric scale: its ATE is scale-corrected."""
    from ur_mvo_tpu_torch.config import SensorSetup

    return vo.setup == SensorSetup.MONO


def emitted_ate(stamps, poses, T_wc, correct_scale):
    """ATE of the emitted trajectory, the accuracy protocol of
    ``scripts/bench_accuracy.py``: scale-corrected for mono, not for the
    metric setups; None below 5 poses, a failed run."""
    import numpy as np

    from ur_mvo_tpu_torch.utils.metrics import ate_rmse

    if len(stamps) < 5:
        return None
    idx = np.clip((np.asarray(stamps) * FPS).round().astype(int), 0, len(T_wc) - 1)
    pos = np.stack([np.asarray(p.translation) for p in poses])
    return float(ate_rmse(pos, T_wc[idx][:, :3, 3], align=True, correct_scale=correct_scale))


def keyframe_ate(vo, T_wc):
    import numpy as np

    from ur_mvo_tpu_torch.utils.metrics import ate_rmse

    kts, kpos, _ = vo.keyframe_trajectory()
    idx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, len(T_wc) - 1)
    return float(ate_rmse(kpos, T_wc[idx][:, :3, 3], align=True, correct_scale=needs_scale(vo))), kts, kpos


def engine_scene(seed, scene="3d"):
    """One 24-frame scene of the accuracy protocol's mono cells (``3d``, or
    ``plane`` / ``decay`` of ``cli.bench_accuracy.SCENES``)."""
    from ur_mvo_tpu_torch.cli.bench_accuracy import SCENES
    from ur_mvo_tpu_torch.components import Frame, Image
    from ur_mvo_tpu_torch.utils.synthscene import render_sequence

    images, T_wc, _ = render_sequence(ENGINE_FRAMES, H, W, FX, seed=seed, **SCENES[scene])
    return [Frame(image=Image(images[i], i / FPS)) for i in range(ENGINE_FRAMES)], T_wc


def collapsed_counted(run, vo, *a, **k):
    """``(run(vo, ...), n)``: ``n`` the frames the run lost while its
    reference keyframe held fewer than ``MULTI_SEQ_COLLAPSED`` triangulated
    points (a collapsed map: ROADMAP C11, C17), as phase 14 counts them."""
    tr, n = vo.tracker, [0]
    process = tr.process

    def traced(*pa, **pk):
        cand, lost = reference_candidates(tr), tr.frames_lost
        out = process(*pa, **pk)
        n[0] += tr.frames_lost > lost and cand is not None and cand < MULTI_SEQ_COLLAPSED
        return out

    tr.process = traced
    try:
        return run(vo, *a, **k), n[0]
    finally:
        del tr.process


def engine_run_counted(vo, seed, scene=None):
    """``engine_run`` with ``frames_lost_collapsed`` in its row."""
    out, n = collapsed_counted(engine_run, vo, seed, scene)
    out[0]["frames_lost_collapsed"] = n
    return out


def engine_run(vo, seed, scene=None):
    """Reset the engine, feed it one scene, and score the run."""
    frames, T_wc = scene or engine_scene(seed)
    vo.reset()
    per_frame, stamps, poses, init_at = run_engine(vo, frames)
    row, kpos = score_run(vo, seed, T_wc, stamps, poses, init_at)
    return row, per_frame, kpos


def score_run(vo, seed, T_wc, stamps, poses, init_at):
    """A run's health and accuracy: the keyframes and the frames they were
    taken at, frames lost, relocalizations, the emitted poses and their ATE
    (``emitted_ate``), and the keyframe trajectory's ATE; and the keyframe
    positions."""
    import numpy as np

    n_kf = vo.tracker.backend.store.num_keyframes()
    kf_ate, kts, kpos = keyframe_ate(vo, T_wc) if n_kf >= 3 else (None, [], np.zeros((0, 3)))
    row = {"seed": seed, "initialised_at_frame": init_at, "keyframes": n_kf,
           "keyframe_frame_ids": [int(round(t * FPS)) for t in kts], "frames_lost": vo.tracker.frames_lost,
           "relocalizations": vo.tracker.relocalizations, "poses_emitted": len(poses), "poses_finite": all(np.isfinite(p.matrix()).all() for p in poses),
           "ate": emitted_ate(stamps, poses, T_wc, needs_scale(vo)), "keyframe_ate": kf_ate}
    return row, kpos


def production_engine(kernels=True, long_run=False):
    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.engine import UR_MVO

    w, h, fx = (LONG_W, LONG_H, LONG_FX) if long_run else (W, H, FX)
    return UR_MVO(production_config(long_run),
                  camera=make_pinhole(w, h, fx, fx, w / 2, h / 2), device="cuda", kernels=kernels)


# the module attribute through which the main path calls each kernel's
# wrapper: engine_sweep's --swap / --only columns point it at the plain
# version, its --audit wraps it
PATH_KERNELS = {
    "stage_conv": ("ur_mvo_tpu_torch.models.superpoint", "stage_conv"),
    "attention": ("ur_mvo_tpu_torch.models.superglue", "attention"),
    "sinkhorn": ("ur_mvo_tpu_torch.models.superglue", "log_optimal_transport_kernel"),
    "pose_gn": ("ur_mvo_tpu_torch.ops.cuda_pose", "pose_gn"),
}


def plain_of(name, fn):
    """The plain version of a ``PATH_KERNELS`` wrapper, same arguments."""
    if name == "pose_gn":
        from ur_mvo_tpu_torch.ops.pose_opt import optimize_pose_plain

        return optimize_pose_plain
    return lambda *a, **k: fn(*a, **{**k, "plain": True})


def route_kernels(routes):
    """Points each named ``PATH_KERNELS`` entry at ``routes[name](name,
    wrapper)``; returns the undo."""
    import importlib

    saved = []
    for name, route in routes.items():
        mod, attr = PATH_KERNELS[name]
        m = importlib.import_module(mod)
        saved.append((m, attr, getattr(m, attr)))
        setattr(m, attr, route(name, getattr(m, attr)))

    def undo():
        for m, attr, fn in reversed(saved):
            setattr(m, attr, fn)

    return undo


def audited(records, frame, threshold):
    """A route that returns the kernel's own result and also runs the plain
    version on the same inputs, appending to ``records`` the frame
    (``frame[0]``; nothing while ``frame[1]``), the kernel and how far apart
    the two are: for the stages and attention the largest error over the
    largest |plain|; for Sinkhorn that, the share of valid rows whose best
    column differs and the matches each decodes at the matcher's
    ``threshold``; for pose GN per problem of the call the inlier counts of
    both and the largest difference of t and of R."""
    from ur_mvo_tpu_torch.ops.matching import decode_assignment

    def route(name, fn):
        plain = plain_of(name, fn)

        def call(*a, **k):
            out = fn(*a, **k)
            if frame[1]:
                return out
            ref = plain(*a, **k)
            rec = {"frame": frame[0], "kernel": name}
            if name == "pose_gn":
                n_k, n_p = out[2].sum(-1).tolist(), ref[2].sum(-1).tolist()
                dt = (out[1] - ref[1]).abs().amax(-1).tolist()
                dR = (out[0] - ref[0]).abs().flatten(1).amax(-1).tolist()
                rec["problems"] = [list(p) for p in zip(n_k, n_p, dt, dR)]
            else:
                o, r = out.float(), ref.float()
                if name == "sinkhorn":
                    keep = r > -1e8
                    rec["err"] = float(((o - r).abs() * keep).amax() / (r.abs() * keep).amax())
                    rows = a[1]  # valid0: (M,) or (S, M)
                    best = (o[..., :-1, :].argmax(-1) != r[..., :-1, :].argmax(-1)) & rows
                    rec["rows_differ"] = float(best.sum() / rows.sum().clamp(min=1))
                    lanes = list(zip(o, r, a[1], a[2])) if o.dim() == 3 else [(o, r, a[1], a[2])]
                    rec["matches"] = [sum(int(decode_assignment(lane[i], v0, v1, threshold).num_valid())
                                          for lane in lanes for v0, v1 in [lane[2:]]) for i in (0, 1)]
                else:
                    rec["err"] = float((o - r).abs().amax() / r.abs().amax().clamp(min=1e-30))
            records.append(rec)
            return out

        return call

    return route


def audit_summary(records, lost_at):
    """Per kernel over one run's audited calls: calls, the largest error;
    for Sinkhorn the largest share of rows whose best column moved; for
    Sinkhorn and the whole matcher the matches decoded from the kernels'
    scores and from the plain versions' on the same inputs (summed, and
    the calls where they differ by 10 or more); for pose GN the problems
    whose inlier count differs from the plain version's, the largest such
    difference, and the frames (lost ones marked) where it is 5 or more."""
    out = {}
    for name in (*PATH_KERNELS, "superglue"):
        rs = [r for r in records if r["kernel"] == name]
        if not rs:
            continue
        if name == "pose_gn":
            probs = [(r["frame"], *p) for r in rs for p in r["problems"]]
            off = [p for p in probs if p[1] != p[2]]
            out[name] = {"calls": len(rs), "problems": len(probs), "inlier_count_differs": len(off),
                         "max_inlier_count_diff": max((abs(p[1] - p[2]) for p in off), default=0),
                         "max_dt": max(p[3] for p in probs), "max_dR": max(p[4] for p in probs),
                         "frames_diff_ge5": sorted({(p[0], p[0] in lost_at) for p in off if abs(p[1] - p[2]) >= 5})}
            continue
        out[name] = {"calls": len(rs)}
        if name != "superglue":
            out[name]["max_err"] = max(r["err"] for r in rs)
        if name == "sinkhorn":
            out[name]["max_rows_differ"] = max(r["rows_differ"] for r in rs)
        if name in ("sinkhorn", "superglue"):
            out[name].update(matches_kernel=sum(r["matches"][0] for r in rs),
                             matches_plain=sum(r["matches"][1] for r in rs),
                             calls_kernel_fewer_by_10=sum(r["matches"][0] <= r["matches"][1] - 10 for r in rs),
                             calls_kernel_more_by_10=sum(r["matches"][0] >= r["matches"][1] + 10 for r in rs))
    return out


def audit_matcher(vo, records, frame):
    """Wraps the engine's SuperGlue ``match_scores``: each call also scores
    the same banks with every kernel on its plain version (the audit's own
    records muted meanwhile) and appends the matches each decodes at the
    matcher's threshold. Returns the undo."""
    from ur_mvo_tpu_torch.ops.matching import decode_assignment

    sg, thr = vo.extractor.superglue, vo.extractor.match_threshold
    scores = sg.match_scores

    def audited_scores(b0, b1, *a, **k):
        Z = scores(b0, b1, *a, **k)
        frame[1], sg.kernels = True, False
        try:
            Zp = scores(b0, b1, *a, **k)
        finally:
            frame[1], sg.kernels = False, True
        n = [int(decode_assignment(z, b0.valid, b1.valid, thr).num_valid()) for z in (Z, Zp)]
        records.append({"frame": frame[0], "kernel": "superglue", "matches": n})
        return Z

    sg.match_scores = audited_scores

    def undo():
        del sg.match_scores

    return undo


def reference_candidates(tracker):
    """The triangulated points of the tracker's reference keyframe (the
    fused step's candidates), None before it initialised; fewer than
    ``MULTI_SEQ_COLLAPSED`` is a collapsed map (ROADMAP C11)."""
    if not tracker.initialized or tracker._ref_slot is None:
        return None
    return int((tracker.fused_snapshot()[:, 3] > 1.5).sum())


def traced_run(vo, seed, frames, routes, audit=False):
    """``engine_run`` with the named kernels routed (``route_kernels``),
    recording per frame the fused step's matches and inliers and the
    triangulated candidates of the reference keyframe it ran against
    (``track``), and the frames lost (``lost_at``); ``audit`` also holds every kernel
    call, and every SuperGlue scoring as a whole, against the plain
    versions on the same inputs (``audited``, ``audit_matcher``,
    ``audit_summary``)."""
    tr, frame, records, track, lost_at = vo.tracker, [0, False], [], {}, []
    process, fused = vo.process, tr._track_frame_fused

    def traced_process(f, **k):
        lost = tr.frames_lost
        out = process(f, **k)
        if tr.frames_lost > lost:
            lost_at.append(frame[0])
        frame[0] += 1
        return out

    def traced_fused(*a, **k):
        cand = reference_candidates(tr)
        res = fused(*a, **k)
        track.setdefault(frame[0], []).append([int(res[0]), int(res[1]), cand])
        return res

    vo.process, tr._track_frame_fused = traced_process, traced_fused
    routes, undo_matcher = dict(routes), None
    if audit:
        route = audited(records, frame, vo.extractor.match_threshold)
        routes.update({n: route for n in PATH_KERNELS if n not in routes})
        undo_matcher = audit_matcher(vo, records, frame)
    undo = route_kernels(routes)
    try:
        row = engine_run(vo, seed, frames)[0]
    finally:
        undo()
        if undo_matcher:
            undo_matcher()
        del vo.process, tr._track_frame_fused
    row.update(lost_at=lost_at, track={str(k): v for k, v in track.items()})
    if audit:
        row["audit"] = audit_summary(records, set(lost_at))
    return row


def engine_sweep(seeds, repeats=2, scene="3d", swap=(), only=(), audit=False):
    """How the engine fares on scenes of a mono cell's family (``3d``,
    ``plane``, ``decay``), and how far one run differs from the next: per
    seed, ``repeats`` runs on the kernels and one on the plain versions;
    for each name in ``swap`` a run on the kernels with that one kernel on
    its plain version (``plain_<name>``), for each in ``only`` a run with
    every other kernel of ``PATH_KERNELS`` on its plain version
    (``only_<name>``). Each run records its frames lost and the fused
    step's matches and inliers per frame (``traced_run``); ``audit`` holds
    every kernel call of the first kernel run against its plain version."""
    engines = {k: production_engine(k) for k in (True, False)}
    to_plain = {n: plain_of for n in PATH_KERNELS}
    columns = [(f"kernels_{r}", True, {}) for r in range(repeats)] + [("plain", False, {})]
    columns += [(f"plain_{n}", True, {n: plain_of}) for n in swap]
    columns += [(f"only_{n}", True, {m: r for m, r in to_plain.items() if m != n}) for n in only]
    for seed in seeds:
        frames = engine_scene(seed, scene)
        row = {"phase": "engine_sweep", "scene": scene, "seed": seed}
        for i, (name, kernels, routes) in enumerate(columns):
            row[name] = traced_run(engines[kernels], seed, frames, routes, audit=audit and i == 0)
        emit(row)


def check_engine_runs(rows, what, max_lost=None, max_ate=MAX_ATE):
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
    if not mean <= max_ate:
        raise AssertionError(f"engine ({what}): mean ATE {mean} over seeds {ENGINE_SEEDS} (<= {max_ate})")
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
    runs = [engine_run_counted(vo, seed, scenes[seed]) for seed in ENGINE_SEEDS]
    launches = dict(cuda_ext.LAUNCHES)
    gn_steps, gn_problems = cuda_pose.steps_run()
    rows = [r[0] for r in runs]
    SINGLE_STREAM_ROWS[:] = rows
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
    plain_runs = [engine_run_counted(plain, s, scenes[s]) for s in ENGINE_SEEDS]
    plain_launches = dict(cuda_ext.LAUNCHES)
    emit({"phase": "engine_plain", "check": "health beside the kernels' (ROADMAP C2)", "seeds": [
        {"seed": s, **{side: {k: r[0][k] for k in ("initialised_at_frame", "frames_lost", "frames_lost_collapsed",
                                                   "poses_emitted", "keyframes", "ate")}
                       for side, r in (("kernels", k_run), ("plain", p_run))}}
        for s, k_run, p_run in zip(ENGINE_SEEDS, runs, plain_runs)], "card": smi})
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


def deterministic_witness(smi):
    """``--deterministic-witness``: what PyTorch's deterministic algorithms
    touch and cost on the ``mono/3d`` protocol (ROADMAP C16), the setting
    the CLIs take on CUDA. (a) seed 11 under
    ``torch.use_deterministic_algorithms(True)`` without ``warn_only``: the
    first op that raises; then under ``warn_only`` with every warning
    recorded: each op that would raise and how often. (b) host ms a frame
    over seeds 11-13 with the setting off and on in turns (off, on, off,
    on; one engine), each run's ATE beside it."""
    import warnings

    import torch

    scenes = {seed: engine_scene(seed) for seed in ENGINE_SEEDS}
    seed = ENGINE_SEEDS[0]
    strict = production_engine()
    torch.use_deterministic_algorithms(True)
    first = None
    try:
        engine_run(strict, seed, scenes[seed])
    except RuntimeError as e:
        first = str(e)[:600]
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    vo = production_engine()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            row = engine_run(vo, seed, scenes[seed])[0]
        finally:
            torch.use_deterministic_algorithms(False)
    ops = collections.Counter(str(w.message).strip().splitlines()[0][:300] for w in caught
                              if "determinis" in str(w.message))
    emit({"phase": "deterministic_witness", "part": "a", "seed": seed, "strict_first_raise": first,
          "warn_only_ops": dict(ops.most_common()), "warn_only_run": row, "card": smi})

    runs = []
    for repeat in range(2):
        for det in (False, True):
            torch.use_deterministic_algorithms(det, warn_only=True)
            for s in ENGINE_SEEDS:
                r, per_frame, _ = engine_run(vo, s, scenes[s])
                after = per_frame[(r["initialised_at_frame"] or 0) + 1:]
                runs.append({"deterministic": det, "repeat": repeat, "seed": s, "ate": r["ate"],
                             "keyframe_ate": r["keyframe_ate"], "host_ms_median": statistics.median(per_frame),
                             "host_ms_after_init": after})
            torch.use_deterministic_algorithms(False)
    vo.shutdown()
    summary = {}
    for det in (False, True):
        mine = [r for r in runs if r["deterministic"] == det]
        pooled = [ms for r in mine for ms in r.pop("host_ms_after_init")]
        summary["on" if det else "off"] = {"host_ms_a_frame_after_init_median": statistics.median(pooled),
                                           "host_ms_a_frame_after_init_mean": statistics.mean(pooled),
                                           "frames": len(pooled)}
    emit({"phase": "deterministic_witness", "part": "b", "runs": runs, "summary": summary,
          "on_over_off": summary["on"]["host_ms_a_frame_after_init_median"]
          / summary["off"]["host_ms_a_frame_after_init_median"], "card": smi})


# ---------------------------------------------------------------------------
# Phase 13: the extras (local-map tracking, resolution buckets, sub-pixel
# peaks, patch descriptors, map snapshots)
# ---------------------------------------------------------------------------

def extras_config(edit=None):
    """``production_config`` (240x320, the checkpoint's operating point,
    relocalization on) with ``edit`` applied."""
    cfg = production_config()
    if edit is not None:
        edit(cfg)
    return cfg


def extras_engine(edit=None, kernels=True):
    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.engine import UR_MVO

    return UR_MVO(extras_config(edit), camera=make_pinhole(W, H, FX, FX, W / 2, H / 2), device="cuda", kernels=kernels)


class LocalMapProbe:
    """What the local-map steps of a run did, read around the tracker's
    ``_track_local_map``: steps whose pose was kept (inliers grew),
    associations added to the frame's track, and the ``pose_gn`` launches
    inside the steps (the launch counts' difference across each step, apart
    from the track step's). It also keeps every step's pose-GN problem (the
    tracker's ``_optimize`` wrapped for the step's length). The tracker's
    ``local_map`` span counts the steps."""

    def __init__(self, vo):
        from ur_mvo_tpu_torch.ops import cuda_ext

        self.launches, self.problems = cuda_ext.LAUNCHES, []
        self.kept = self.added = self.pose_gn = 0
        tracker = vo.tracker
        step, optimize = tracker._track_local_map, tracker._optimize
        cam, topt = tracker.camera, tracker.cfg.tracking_optimization
        geom = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)

        def captured(R0, t0, obs, rounds=4):
            kw = {"rounds": rounds, "chi2_mono": topt.mono_point, "chi2_stereo": topt.stereo_point}
            self.problems.append((R0.clone(), t0.clone(), type(obs)(*(f.clone() for f in obs)), geom, kw))
            return optimize(R0, t0, obs, rounds=rounds)

        def probed(bank, pose, frame_track, num_inliers):
            before = self.launches.get("pose_gn", 0)
            tracker._optimize = captured
            try:
                new_pose, new_track, n = step(bank, pose, frame_track, num_inliers)
            finally:
                del tracker._optimize
            self.pose_gn += self.launches.get("pose_gn", 0) - before
            self.kept += int(n > num_inliers)
            self.added += int((new_track >= 0).sum() - (frame_track >= 0).sum())
            return new_pose, new_track, n

        tracker._track_local_map = probed

    def read(self):
        """(steps kept, associations added, pose_gn launches) since the last
        read."""
        out = (self.kept, self.added, self.pose_gn)
        self.kept = self.added = self.pose_gn = 0
        return out


# the row orders the local-map check draws at most, one plain call each at
# the path's own batch of one (a batched call splits its sums otherwise)
LOCAL_MAP_TWINS = 64


def local_map_kernel_check(problems, smi):
    """Every captured local-map problem (B = 1, N = capacity, one round)
    through the pose-GN kernel against the plain optimizer's full schedule
    on the card, at the pose phase's limits (R 2e-5, t 2e-4, inlier flags
    equal on >= 99%). On a few-inlier problem one round stops at a fixed
    point in a flat valley, and which one depends on the rounding of the
    cost sums: the plain version run on the rows in another order (a twin:
    the same function, another rounding) stops at another. So where the
    kernel is outside those limits of the plain version, the plain version
    is run on other orders (up to ``LOCAL_MAP_TWINS``) until one lands
    within those limits of the kernel: the kernel's endpoint must be one the
    plain version itself reaches. For those problems the orders drawn, the
    twins' spread and how far the plain version still moves in 30 more steps
    are printed. On each of them a near miss, the kernel's pose with t moved
    1.5 limits, goes through the same search over the same twins and must
    not meet it. The plain version's full 4-round schedule on the same
    problem (the control, another function) must miss the plain version and
    the twins drawn on most problems. The times are those of the problem
    with the most valid rows."""
    import torch

    from ur_mvo_tpu_torch.ops.pose_opt import optimize_pose, optimize_pose_plain

    TOL_R, TOL_T = 2e-5, 2e-4
    rows, widest = [], None

    def distance(a, b):
        """Largest of the R and t differences, each over its limit, and the
        inlier agreement."""
        d = max((a[0] - b[0]).abs().max().item() / TOL_R, (a[1] - b[1]).abs().max().item() / TOL_T)
        return d, (a[2] == b[2]).float().mean().item()

    for R0, t0, obs, geom, kw in problems:
        rounds, chi2 = kw["rounds"], (kw["chi2_mono"], kw["chi2_stereo"])
        N = obs.X.shape[0]

        def plain(rounds=rounds, iters=10):
            R, t, inl, _ = optimize_pose_plain(R0[None], t0[None], obs.X[None], obs.uv[None], obs.valid[None], *geom,
                                               *chi2, rounds=rounds, iters_per_round=iters, full_schedule=True)
            return R[0], t[0], inl[0]

        def twin(perm):
            """The plain version on the rows in another order; inlier flags
            back in the rows' own order."""
            R, t, inl, _ = optimize_pose_plain(R0[None], t0[None], obs.X[perm][None], obs.uv[perm][None],
                                               obs.valid[perm][None], *geom, *chi2, rounds=rounds, full_schedule=True)
            return R[0], t[0], torch.empty_like(inl[0]).index_copy_(0, perm, inl[0])

        out = optimize_pose(R0, t0, obs, *geom, chi2_mono=chi2[0], chi2_stereo=chi2[1], rounds=rounds)
        kernel, ref = (out.R_cw, out.t_cw, out.inliers), plain()
        to_plain, agree = distance(kernel, ref)
        control = plain(rounds=4)
        r = {"valid_rows": int(obs.valid.sum()), "n_inliers": int(out.n_inliers), "rounds": rounds, "N": int(N),
             "to_plain": to_plain, "inlier_agreement": agree, "to_nearest": to_plain, "nearest_inlier_agreement": agree,
             "control_to_plain": distance(control, ref)[0]}
        if not (to_plain <= 1.0 and agree >= 0.99):
            g, drawn = torch.Generator().manual_seed(0), []

            def nearest(pose):
                """The twins drawn in one fixed sequence (shared by every
                pose searched) until one lands within the limits of
                ``pose``: (distance, inlier agreement, orders drawn)."""
                best = (float("inf"), 0.0)
                for k in range(1, LOCAL_MAP_TWINS + 1):
                    if len(drawn) < k:
                        drawn.append(twin(torch.randperm(N, generator=g).to(obs.X.device)))
                    best = min(best, distance(pose, drawn[k - 1]), key=lambda da: da[0])
                    if best[0] <= 1.0 and best[1] >= 0.99:
                        break
                return (*best, k)

            r["to_nearest"], r["nearest_inlier_agreement"], r["orders_drawn"] = nearest(kernel)
            # the near-miss control: the kernel's pose with t moved 1.5 limits
            # further from the plain version's, every component (a move toward
            # it could land on the plain version's own endpoint, a right
            # answer); the same search must reject it
            step = ((kernel[1] >= ref[1]).float() * 3.0 - 1.5) * TOL_T
            near_miss = nearest((kernel[0], kernel[1] + step, kernel[2]))
            r["near_miss_to_nearest"], r["near_miss_orders_drawn"] = near_miss[0], near_miss[2]
            r["near_miss_met"] = near_miss[0] <= 1.0 and near_miss[1] >= 0.99
            r["twin_spread"] = max(distance(tw, ref)[0] for tw in drawn)
            r["control_to_nearest"] = min(distance(control, tw)[0] for tw in [ref] + drawn)
            r["plain_moves_in_30_more_steps"] = distance(ref, plain(iters=40))[0]
        rows.append(r)
        if widest is None or r["valid_rows"] > widest[0]["valid_rows"]:
            widest = (r, (R0, t0, obs, geom, chi2, rounds))
    r, (R0, t0, obs, geom, chi2, rounds) = widest
    call = lambda: optimize_pose(R0, t0, obs, *geom, chi2_mono=chi2[0], chi2_stereo=chi2[1], rounds=rounds)  # noqa: E731
    timing = {"valid_rows": r["valid_rows"], "ms": device_ms(call, ("pose_gn_kernel",))[0], "wall_ms": time_ms(call),
              "plain_ms": device_ms(lambda: optimize_pose(R0, t0, obs, *geom, chi2_mono=chi2[0], chi2_stereo=chi2[1],
                                                          rounds=rounds, plain=True), calls=3)[0]}
    ok = [x["to_nearest"] <= 1.0 and x["nearest_inlier_agreement"] >= 0.99 for x in rows]
    twinned = [x for x in rows if "twin_spread" in x]
    control_misses = sum(x.get("control_to_nearest", x["control_to_plain"]) > 1.0 for x in rows)
    summary = {"phase": "extras", "check": "local_map_pose_gn", "problems": len(rows), "tol_R": TOL_R, "tol_t": TOL_T,
               "within_limits_of_plain": len(rows) - len(twinned),
               "within_limits_of_plain_or_a_twin": sum(ok),
               "orders_drawn": [x["orders_drawn"] for x in twinned],
               "largest_to_plain": max(x["to_plain"] for x in rows), "largest_to_nearest": max(x["to_nearest"] for x in rows),
               "largest_twin_spread": max((x["twin_spread"] for x in twinned), default=None),
               "largest_plain_move_in_30_more_steps": max((x["plain_moves_in_30_more_steps"] for x in twinned), default=None),
               "control_misses": control_misses, "smallest_control_distance": min(x["control_to_plain"] for x in rows),
               "near_miss_to_nearest": [x["near_miss_to_nearest"] for x in twinned],
               "near_misses_met": sum(x["near_miss_met"] for x in twinned),
               "timing_B1_N1024_one_round": timing, "card": smi}
    emit(summary)
    emit({"phase": "extras", "check": "local_map_pose_gn_problems", "outside_limits_of_plain": twinned})
    if any(x["rounds"] != 1 or x["N"] != 1024 for x in rows):
        raise AssertionError("extras: a local-map problem ran other than one round at N = 1024")
    if not all(ok):
        raise AssertionError(f"extras: {len(rows) - sum(ok)} of {len(rows)} local-map problems outside the pose "
                             f"phase's limits of the plain version and of every order of its rows drawn")
    if any(x["near_miss_met"] for x in twinned):
        raise AssertionError(f"extras: a pose 1.5 t-limits from the kernel's met the twin search on "
                             f"{sum(x['near_miss_met'] for x in twinned)} of {len(twinned)} problems: the search "
                             f"does not reject a near miss")
    if not control_misses > len(rows) / 2:
        raise AssertionError(f"extras: the 4-round control met the criterion on {len(rows) - control_misses} "
                             f"of {len(rows)} problems: it does not tell one function from another")
    return summary


def extras_local_map(smi, launches):
    """``mono/3d`` with ``local_map_tracking.enabled``: the production mono
    engine over the protocol's scenes, each run's health, its local-map steps
    launching pose GN, and one captured step checked on the kernel."""
    from ur_mvo_tpu_torch.ops import cuda_ext

    vo = extras_engine(lambda c: setattr(c.local_map_tracking, "enabled", True))
    probe = LocalMapProbe(vo)
    cuda_ext.LAUNCHES.clear()
    rows, counted = [], 0
    for seed in ENGINE_SEEDS:
        row, per_frame, _ = engine_run(vo, seed)
        kept, added, gn = probe.read()
        steps = vo.tracker.timer.summary().get("local_map", {}).get("count", 0) - counted
        counted += steps
        row.update({"local_map_steps": steps, "local_map_steps_kept": kept,
                    "mean_associations_added": added / max(steps, 1), "local_map_pose_gn_launches": gn,
                    "host_ms_a_frame_median": statistics.median(per_frame)})
        rows.append(row)
    launches["mono/3d+local_map"] = dict(cuda_ext.LAUNCHES)
    gn_local = sum(r["local_map_pose_gn_launches"] for r in rows)
    launches["local_map_step"] = {"pose_gn": gn_local}
    stage = vo.tracker.timer.summary().get("local_map", {})
    emit({"phase": "extras", "check": "mono/3d+local_map", "runs": rows, "jax_cpu": LOCAL_MAP_JAX,
          "launches": launches["mono/3d+local_map"],
          "local_map_pose_gn_launches": gn_local,
          "track_pose_gn_launches": launches["mono/3d+local_map"].get("pose_gn", 0) - gn_local,
          "local_map_host_ms": {"count": stage.get("count"), "mean_ms": stage.get("mean_ms"), "max_ms": stage.get("max_ms")},
          "card": smi})
    vo.shutdown()
    # the JAX package misses mono/3d's gate with local-map tracking on these
    # scenes (fewer than 5 poses emitted, LOCAL_MAP_JAX): the run is held to
    # its health, its ATE printed beside the JAX package's (ROADMAP C9)
    for r in rows:
        where = f"extras (mono/3d+local_map, seed {r['seed']})"
        if r["initialised_at_frame"] is None or r["keyframes"] < MIN_KEYFRAMES or not r["poses_finite"]:
            raise AssertionError(f"{where}: initialised at {r['initialised_at_frame']}, {r['keyframes']} keyframes, "
                                 f"finite poses {r['poses_finite']}")
        if r["frames_lost"] > MAX_FRAMES_LOST:
            raise AssertionError(f"{where}: {r['frames_lost']} frames lost (<= {MAX_FRAMES_LOST})")
    missing = [k for k in ENGINE_KERNELS if launches["mono/3d+local_map"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"extras (mono/3d+local_map): kernels of the path never launched: {missing}")
    if gn_local <= 0:
        raise AssertionError("extras (mono/3d+local_map): the local-map steps launched pose GN no time")
    return local_map_kernel_check(probe.problems, smi)


def extras_buckets(smi, launches):
    """Resolution buckets: frame 0 of the seed-11 scene through a (288, 384)
    bucket against the native extraction (the interior keypoints within
    0.5 px, ``tests/test_resolution_buckets.py``), a 216x288 crop through
    it, the bucketed bank against the plain versions on the card (phase 5's
    overlap), the stage kernels launched at the bucket's shape; then an
    engine pass with a (240, 320) bucket and every third frame cropped."""
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.components import Frame, Image
    from ur_mvo_tpu_torch.models import superpoint as sp_module
    from ur_mvo_tpu_torch.ops import cuda_ext
    from ur_mvo_tpu_torch.runtime.extractor import NeuralExtractor
    from ur_mvo_tpu_torch.utils.metrics import ate_rmse
    from ur_mvo_tpu_torch.utils.synthscene import render_sequence

    cam = make_pinhole(W, H, FX, FX, W / 2, H / 2)
    img = engine_scene(ENGINE_SEEDS[0])[0][0].image.get_image()

    def bucketed(c):
        c.superpoint.resolution_buckets = [EXTRAS_BUCKET]

    native = NeuralExtractor(extras_config(), cam, device="cuda")
    ext = NeuralExtractor(extras_config(bucketed), cam, device="cuda")
    plain = NeuralExtractor(extras_config(bucketed), cam, device="cuda", kernels=False)
    shapes, stage_conv = [], sp_module.stage_conv

    def recorded(x, *args, **kw):
        shapes.append(list(x.shape))
        return stage_conv(x, *args, **kw)

    cuda_ext.LAUNCHES.clear()
    sp_module.stage_conv = recorded
    try:
        b1 = ext.extract(img)
        torch.cuda.synchronize()
    finally:
        sp_module.stage_conv = stage_conv
    stage_launches = {k: v for k, v in cuda_ext.LAUNCHES.items() if k.startswith("stage")}
    b0 = native.extract(img)
    crop = ext.extract(img[:216, :288])
    bp = plain.extract(img)
    k0 = b0.kpts.cpu().numpy()[b0.valid.cpu().numpy()]
    k1 = b1.kpts.cpu().numpy()[b1.valid.cpu().numpy()]
    kc = crop.kpts.cpu().numpy()[crop.valid.cpu().numpy()]
    interior = (k0[:, 0] < W - 48) & (k0[:, 1] < H - 48)
    near = (np.abs(k0[interior][:, None, :] - k1[None, :, :]).sum(-1).min(1) < 0.5).mean()
    a, c = kpt_set(b1), kpt_set(bp)
    overlap = len(a & c) / max(len(a), len(c), 1)
    border = extras_config().superpoint.remove_borders

    # the engine through a (240, 320) bucket, every third frame a bottom-right crop
    images, T_wc, _ = render_sequence(BUCKET_FRAMES, H, W, FX, seed=4, n_planes=3)
    def engine_edit(c):
        c.superpoint.resolution_buckets = [(H, W)]
        # the init thresholds of tests/test_resolution_buckets.py's engine pass
        c.initializer.min_matches = 40
        c.initializer.min_features_first = 80

    vo = extras_engine(engine_edit)
    frames = [Frame(image=Image(images[i] if i % 3 else images[i][: H - 24, : W - 32], i / FPS))
              for i in range(BUCKET_FRAMES)]
    cuda_ext.LAUNCHES.clear()
    _, _, _, init_at = run_engine(vo, frames)
    launches["buckets"] = dict(cuda_ext.LAUNCHES)
    kts, kpos, _ = vo.keyframe_trajectory()
    idx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, BUCKET_FRAMES - 1)
    ate = float(ate_rmse(kpos, T_wc[idx][:, :3, 3], align=True, correct_scale=True)) if len(kts) >= 2 else None
    row = {"phase": "extras", "check": "buckets", "bucket": list(EXTRAS_BUCKET), "keypoints_native": len(k0),
           "keypoints_bucketed": len(k1), "interior": int(interior.sum()), "interior_within_half_px": near,
           "bucketed_max_xy": k1.max(0).tolist(), "crop": [216, 288], "crop_keypoints": len(kc),
           "crop_max_xy": kc.max(0).tolist() if len(kc) else None, "keypoint_overlap_plain": overlap,
           "stage_input_shapes": shapes, "stage_launches": stage_launches,
           "engine": {"bucket": [H, W], "frames": BUCKET_FRAMES, "initialised_at_frame": init_at,
                      "keyframes": len(kts), "frames_lost": vo.tracker.frames_lost, "keyframe_ate": ate,
                      "max_ate": BUCKET_MAX_ATE, "launches": launches["buckets"]},
           "card": smi}
    emit(row)
    vo.shutdown()
    if not (near > 0.99 and len(k1) > 100 and (k1[:, 0] <= W - border).all() and (k1[:, 1] <= H - border).all()):
        raise AssertionError(f"extras (buckets): {near} of the interior keypoints within 0.5 px (> 0.99), "
                             f"{len(k1)} keypoints, largest {k1.max(0).tolist()} (<= {W - border}, {H - border})")
    if not (len(kc) > 100 and (kc[:, 0] <= 288 - border).all() and (kc[:, 1] <= 216 - border).all()):
        raise AssertionError(f"extras (buckets): the 216x288 crop gave {len(kc)} keypoints, largest "
                             f"{kc.max(0).tolist() if len(kc) else None}")
    if overlap < 0.95:
        raise AssertionError(f"extras (buckets): kernel path vs plain path overlap {overlap} (>= 0.95)")
    if not ([1, EXTRAS_BUCKET[0], EXTRAS_BUCKET[1], 1] in shapes and stage_launches.get("stage1_conv", 0) > 0
            and stage_launches.get("stage_conv", 0) > 0):
        raise AssertionError(f"extras (buckets): stage kernels at {shapes}, launches {stage_launches}")
    if init_at is None or ate is None or not ate < BUCKET_MAX_ATE:
        raise AssertionError(f"extras (buckets): engine initialised at {init_at}, keyframe ATE {ate} (< {BUCKET_MAX_ATE})")
    return row


def subpixel_pairs(a, b):
    """Two (integer picks, refined keypoints, valid) extractions of one frame:
    the overlap of their integer picks, and over the common picks the
    largest refined difference and the share within 1e-3 px."""
    import numpy as np

    ra = {tuple(p): q for p, q in zip(a[0][a[2]], a[1][a[2]])}
    rb = {tuple(p): q for p, q in zip(b[0][b[2]], b[1][b[2]])}
    common = sorted(set(ra) & set(rb))
    diff = np.array([np.abs(ra[p] - rb[p]).max() for p in common]) if common else np.array([np.inf])
    return {"integer_sets_equal": set(ra) == set(rb), "integer_overlap": len(common) / max(len(ra), len(rb), 1),
            "refined_max_diff_px": float(diff.max()), "refined_within_1e-3": float((diff <= 1e-3).mean())}


# the share of the common picks whose refined keypoints the float32 kernels
# and their plain versions must place within 1e-3 px of each other, end to
# end: the H100 (700 W) read 0.962 there and 0.132 in bf16 (PERF.md, PR 12)
SUBPIXEL_WITHIN = 0.9


def extras_subpixel(smi):
    """Sub-pixel peaks on frame 0 of the seed-11 scene. (a) The refinement
    on the card against the plain function on the CPU on the same score
    maps (the kernel path's, float32): the same picks slot by slot, refined
    keypoints within 1e-3 px, offsets most nonzero, and the same bank from
    ``NeuralExtractor.extract``. (b) The kernels against their plain
    versions on the card, end to end, in float32 and bf16: phase 5's
    overlap of the integer picks (the same configuration without sub-pixel)
    and, in float32, at least ``SUBPIXEL_WITHIN`` of the common picks'
    refined keypoints within 1e-3 px (bf16's reading is reported: its score
    maps round too coarsely for that). ``select_keypoints`` clamps every
    offset to 0.5 px, so no bound on offsets is checked. (c) The plain
    versions on the card against the CPU's in float32, reported: how far two
    roundings of the same network move the picks."""
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.ops.keypoints import select_keypoints
    from ur_mvo_tpu_torch.runtime.extractor import NeuralExtractor

    cam = make_pinhole(W, H, FX, FX, W / 2, H / 2)
    img = engine_scene(ENGINE_SEEDS[0])[0][0].image.get_image()

    def config(sub, dtype):
        def edit(c):
            c.superpoint.subpixel = sub
            c.runtime.compute_dtype = dtype

        return extras_config(edit)

    def extraction(dtype, kernels=True, device="cuda"):
        """(integer picks, refined keypoints, valid) as host arrays."""
        banks = [NeuralExtractor(config(sub, dtype), cam, device=device, kernels=kernels).extract(img)
                 for sub in (False, True)]
        return banks[0].kpts.cpu().numpy(), banks[1].kpts.cpu().numpy(), banks[0].valid.cpu().numpy()

    # (a) one set of score maps, refined on the card and on the CPU
    sp_cfg = config(True, "float32").superpoint
    ext = NeuralExtractor(config(True, "float32"), cam, device="cuda")
    x = torch.as_tensor(img, device="cuda").to(torch.float32) / 255.0
    with torch.no_grad():
        scores, desc, raw = ext.superpoint(x[None, :, :, None], nms_radius=sp_cfg.nms_radius, return_raw_scores=True)
    kw = dict(capacity=sp_cfg.capacity, threshold=sp_cfg.keypoint_threshold, border=sp_cfg.remove_borders,
              max_keypoints=sp_cfg.max_keypoints)
    card = select_keypoints(scores[0], desc[0], raw_scores=raw[0], **kw)
    host = select_keypoints(scores[0].cpu(), desc[0].cpu(), raw_scores=raw[0].cpu(), **kw)
    ints = select_keypoints(scores[0], desc[0], **kw)
    ints_host = select_keypoints(scores[0].cpu(), desc[0].cpu(), **kw)
    path = ext.extract(img)
    v = card.valid.cpu().numpy()
    kc, kh, ki = card.kpts.cpu().numpy()[v], host.kpts.cpu().numpy()[v], ints.kpts.cpu().numpy()[v]
    moved = kc - ki
    same_maps = {"keypoints": int(v.sum()),
                 "picks_equal": bool(torch.equal(ints.valid.cpu(), ints_host.valid) and torch.equal(ints.kpts.cpu(), ints_host.kpts)
                                     and torch.equal(card.valid.cpu(), host.valid)),
                 "refined_max_diff_px": float(np.abs(kc - kh).max()), "offsets_nonzero": float((moved != 0).any(-1).mean()),
                 "extract_equal": bool(torch.equal(path.kpts, card.kpts) and torch.equal(path.valid, card.valid))}
    row = {"phase": "extras", "check": "subpixel", "same_score_maps": same_maps, "card": smi}
    for dtype in ("float32", "bfloat16"):
        k, p = extraction(dtype), extraction(dtype, kernels=False)
        row[f"kernels_vs_plain_{dtype}"] = {**subpixel_pairs(k, p), "keypoints": int(k[2].sum())}
    row["plain_card_vs_cpu_float32"] = subpixel_pairs(extraction("float32", kernels=False),
                                                      extraction("float32", kernels=False, device="cpu"))
    emit(row)
    if not (same_maps["picks_equal"] and same_maps["keypoints"] > MIN_KEYPOINTS and same_maps["extract_equal"]
            and same_maps["refined_max_diff_px"] <= 1e-3 and same_maps["offsets_nonzero"] > 0.5):
        raise AssertionError(f"extras (subpixel): on one set of score maps {same_maps}")
    for dtype in ("float32", "bfloat16"):
        r = row[f"kernels_vs_plain_{dtype}"]
        if not (r["integer_overlap"] >= 0.95 and (dtype != "float32" or r["refined_within_1e-3"] >= SUBPIXEL_WITHIN)):
            raise AssertionError(f"extras (subpixel, {dtype}): kernels vs plain {r}")
    return row


def extras_patch(smi, launches):
    """``tests/test_patch_desc.py``'s from-scratch configuration through
    ``UR_MVO.process`` on the card: ``superpoint_scratch_v2``, patch
    descriptors, matcher ``nn``, float32, on a rendered plane (the port's
    ``utils/synthscene``, ``bench_accuracy.py``'s plane scene)."""
    import numpy as np

    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.components import Frame, Image
    from ur_mvo_tpu_torch.config import Configs
    from ur_mvo_tpu_torch.engine import UR_MVO
    from ur_mvo_tpu_torch.ops import cuda_ext
    from ur_mvo_tpu_torch.utils.metrics import ate_rmse
    from ur_mvo_tpu_torch.utils.synthscene import render_sequence

    cfg = Configs()
    cfg.superpoint.capacity = 512
    cfg.superpoint.max_keypoints = 400
    cfg.superpoint.keypoint_threshold = 1e-4
    cfg.superpoint.weights_path = PATCH_WEIGHTS
    cfg.superpoint.descriptor_source = "patch"
    cfg.superglue.matcher = "nn"
    cfg.superglue.image_width, cfg.superglue.image_height = W, H
    cfg.initializer.min_matches = 50
    cfg.initializer.min_features_first = 100
    cfg.backend.window_opt_frames = 8
    cfg.backend.window_fixed_frames = 6
    cfg.backend.ba_max_points = 1024
    cfg.backend.ba_max_observations = 4096
    cfg.backend.ba_iterations_phase1 = 6
    cfg.backend.ba_iterations_phase2 = 3
    cfg.runtime.compute_dtype = "float32"
    images, T_wc, _ = render_sequence(PATCH_FRAMES, H, W, FX, seed=0, n_planes=0, z_background=4.0)
    vo = UR_MVO(cfg, camera=make_pinhole(W, H, FX, FX, W / 2, H / 2), device="cuda")
    cuda_ext.LAUNCHES.clear()
    _, _, _, init_at = run_engine(vo, [Frame(image=Image(images[i], i / FPS)) for i in range(PATCH_FRAMES)])
    launches["patch"] = dict(cuda_ext.LAUNCHES)
    kts, kpos, _ = vo.keyframe_trajectory()
    idx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, PATCH_FRAMES - 1)
    ate = float(ate_rmse(kpos, T_wc[idx][:, :3, 3], align=True, correct_scale=True)) if len(kts) >= 2 else None
    row = {"phase": "extras", "check": "patch", "frames": PATCH_FRAMES, "initialised_at_frame": init_at,
           "keyframes": len(kts), "frames_lost": vo.tracker.frames_lost, "keyframe_ate": ate, "max_ate": PATCH_MAX_ATE,
           "launches": launches["patch"], "card": smi}
    emit(row)
    vo.shutdown()
    if init_at is None or len(kts) < PATCH_MIN_KEYFRAMES or ate is None or not ate < PATCH_MAX_ATE:
        raise AssertionError(f"extras (patch): initialised at {init_at}, {len(kts)} keyframes (>= {PATCH_MIN_KEYFRAMES}), "
                             f"keyframe ATE {ate} (< {PATCH_MAX_ATE})")
    missing = [k for k in ("stage1_conv", "stage_conv", "pose_gn") if launches["patch"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"extras (patch): kernels of the path never launched: {missing}")
    return row


def store_fields_equal(a, b):
    """The snapshot's fields of two map stores that differ, by name."""
    import numpy as np

    differ = [f for f in a._SNAPSHOT_FIELDS + ("mp_desc", "kf_gdesc")
              if not (getattr(a, f).dtype == getattr(b, f).dtype and np.array_equal(getattr(a, f), getattr(b, f)))]
    for f in ("kf_desc", "kf_scores"):
        x, y = getattr(a, f), getattr(b, f)
        if sorted(x) != sorted(y) or not all(np.array_equal(x[k], y[k]) for k in x):
            differ.append(f)
    if (a._next_kf, a._next_mp, a._free_kf, a._free_mp, a.frame_id_to_slot) != (
            b._next_kf, b._next_mp, b._free_kf, b._free_mp, b.frame_id_to_slot):
        differ.append("allocation")
    if len(a.loop_edges) != len(b.loop_edges):
        differ.append("loop_edges")
    return differ


def extras_snapshot(smi, launches):
    """Session A: the production mono engine over frames 0-15 of the seed-11
    scene, then ``save_map_snapshot``; ``MapStore.load_snapshot`` must give
    back every field bit for bit. Session B: a fresh engine,
    ``load_map_snapshot``, frames 16-23 (``tests/test_map_reuse.py``'s resume
    protocol): initialised without an init attempt, at least one keyframe
    added, the keyframe ATE over both sessions (one similarity alignment)
    beside the JAX package's; then ``save_map_ply``, one vertex per good map
    point."""
    import tempfile

    import numpy as np

    from ur_mvo_tpu_torch.ops import cuda_ext
    from ur_mvo_tpu_torch.runtime.map_store import MapStore
    from ur_mvo_tpu_torch.utils.metrics import ate_rmse

    frames, T_wc = engine_scene(ENGINE_SEEDS[0])
    cuda_ext.LAUNCHES.clear()
    vo_a = extras_engine()
    run_engine(vo_a, frames[:SNAPSHOT_SPLIT])
    st_a = vo_a.tracker.backend.store
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        vo_a.save_map_snapshot(path)
        differ = store_fields_equal(MapStore.load_snapshot(path, st_a.cfg), st_a)
        vo_b = extras_engine()
        attempts = []
        init = vo_b.tracker._try_initialize
        vo_b.tracker._try_initialize = lambda *a, **k: attempts.append(1) or init(*a, **k)
        vo_b.load_map_snapshot(path)
        on_load = vo_b.tracker.initialized
        run_engine(vo_b, frames[SNAPSHOT_SPLIT:])
        launches["snapshot"] = dict(cuda_ext.LAUNCHES)
        ply = os.path.join(tmp, "map.ply")
        vo_b.save_map_ply(ply)
        with open(ply) as f:
            lines = f.read().splitlines()
    st = vo_b.tracker.backend.store
    good = int((st.mp_good & ~st.mp_bad).sum())
    vertices = len(lines) - lines.index("end_header") - 1
    kts, kpos, _ = vo_b.keyframe_trajectory()
    idx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, ENGINE_FRAMES - 1)
    ate = float(ate_rmse(kpos, T_wc[idx][:, :3, 3], align=True, correct_scale=True))
    row = {"phase": "extras", "check": "snapshot", "frames": [SNAPSHOT_SPLIT, ENGINE_FRAMES - SNAPSHOT_SPLIT],
           "keyframes_a": st_a.num_keyframes(), "keyframes_after_b": st.num_keyframes(),
           "fields_differing_after_load": differ, "initialised_on_load": on_load, "init_attempts_b": len(attempts),
           "relocalizations_b": vo_b.tracker.relocalizations, "frames_lost_b": vo_b.tracker.frames_lost,
           "keyframe_ate_both_sessions": ate, "jax_cpu": SNAPSHOT_JAX, "ply_vertices": vertices,
           "good_points": good, "launches": launches["snapshot"], "card": smi}
    emit(row)
    vo_a.shutdown()
    vo_b.shutdown()
    if differ:
        raise AssertionError(f"extras (snapshot): fields {differ} differ after load_snapshot")
    if not on_load or attempts or st.num_keyframes() <= st_a.num_keyframes():
        raise AssertionError(f"extras (snapshot): session B initialised on load {on_load}, init attempts "
                             f"{len(attempts)}, keyframes {st_a.num_keyframes()} -> {st.num_keyframes()}")
    # the JAX package's keyframe ATE over both sessions is above mono/3d's
    # gate on this scene (SNAPSHOT_JAX): the ATE is printed beside it, and
    # the sessions are held to their health (ROADMAP C10)
    if not np.isfinite(ate) or vo_b.tracker.frames_lost > MAX_FRAMES_LOST:
        raise AssertionError(f"extras (snapshot): keyframe ATE {ate}, {vo_b.tracker.frames_lost} frames lost in "
                             f"session B (<= {MAX_FRAMES_LOST})")
    if vertices != good or good == 0:
        raise AssertionError(f"extras (snapshot): the PLY holds {vertices} vertices for {good} good map points")
    return row


def extras_phase(smi):
    """Phase 13: each feature of the slice through the entry points a user
    calls, at the production operating point, under deterministic
    algorithms (as phase 8). A failed check is reported and the phase goes on
    to the next; it fails at the end if any did. Returns each path's launch
    counts."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    launches, failures = {}, []
    for name, fn, args in (("mono/3d+local_map", extras_local_map, (smi, launches)),
                           ("buckets", extras_buckets, (smi, launches)), ("subpixel", extras_subpixel, (smi,)),
                           ("patch", extras_patch, (smi, launches)), ("snapshot", extras_snapshot, (smi, launches))):
        t0 = time.perf_counter()
        try:
            fn(*args)
        except AssertionError as e:
            emit({"phase": "extras", "check": name, "failed": str(e)})
            failures.append(name)
        emit({"phase": "extras", "check": name, "seconds": time.perf_counter() - t0})
    if failures:
        raise AssertionError(f"extras: checks failed: {failures}")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: multi-sequence concurrent VO (parallel/multi_seq.MultiSequenceVO)
# ---------------------------------------------------------------------------

def multi_seq_batch_invariance(smi):
    """Each kernel at the batch the lock-step frame gives it, item by item
    against its launch at the single stream's batch, bit for bit, and
    against its plain version within phase 3's limits: the three stages on
    frame 0 of the ``mono/3d`` scenes of seeds 11-13 at B = 3 against B = 1;
    attention at B = 6 (three pairs, different valid counts a bank) against
    each pair's B = 2 launch; the transport of three lanes through the
    batched wrapper against each lane's call; pose GN at B = 6 (three lanes'
    two problems at N = 1024, one lane's problem without outliers, so that
    the lanes skip rounds differently) against each lane's B = 2 launch."""
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops import cuda_conv, cuda_ext, cuda_kernels
    from ur_mvo_tpu_torch.ops.pose_opt import optimize_pose, optimize_pose_plain
    from ur_mvo_tpu_torch.utils.synthscene import render_sequence

    dev = torch.device("cuda")
    ext = cuda_ext.extension()
    row, bad = {"phase": "multi_seq", "check": "batch_invariance", "card": smi}, []

    # --- the stage kernels: B = 3 against B = 1 --------------------------
    frames = np.stack([render_sequence(1, H, W, FX, seed=s, n_planes=3, z_background=6.0)[0][0] for s in ENGINE_SEEDS])
    x = (torch.from_numpy(frames).to(dev).float() / 255.0).to(torch.bfloat16)[..., None]
    singles = [x[i : i + 1] for i in range(len(ENGINE_SEEDS))]
    sp = shipped_superpoint()
    stages = []
    for name in STAGE_CONVS:
        ca, cb = stage_convs(sp, name)
        args = (ca.weight, ca.bias, cb.weight, cb.bias)
        packed = cuda_conv.pack_stage(*args, x.dtype)
        ref = cuda_conv.stage_conv_plain(x, *args)
        out = cuda_conv.stage_conv(x, *args, packed=packed)
        singles = [cuda_conv.stage_conv(s, *args, packed=packed) for s in singles]
        B, Hs, Ws, Cin = x.shape
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2.0**-6 * ref.float().abs().max().item()
        same = [bool(torch.equal(out[i : i + 1], s)) for i, s in enumerate(singles)]
        info = ext.stage_conv_info(Cin, ca.weight.shape[0], cb.weight.shape[0], B, Hs, Ws)
        stages.append({"stage": name, "B": B, "items_equal_B1": same, "max_abs_err": err, "tol": tol,
                       "blocks": info["blocks"], "tiles": info["tiles"]})
        if not (all(same) and err <= tol):
            bad.append(f"{name} at B = {B}: items equal to B = 1 {same}, max |err| {err} (<= {tol})")
        x, singles = out, [out[i : i + 1] for i in range(B)]  # the next stage reads the batch's output
    row["stages"] = stages

    # --- attention: B = 6 against each pair's B = 2 -----------------------
    rng = np.random.RandomState(14)
    counts = (1000, 937, 990, 1000, 870, 955)
    q, k, v = (torch.from_numpy(rng.standard_normal((6, 1024, 4, 64)).astype(np.float32)).to(dev).to(torch.bfloat16)
               for _ in range(3))
    valid = torch.arange(1024, device=dev)[None] < torch.tensor(counts, device=dev)[:, None]
    out = cuda_kernels.attention(q, k, v, valid)
    ref = cuda_kernels.attention_plain(q, k, v, valid)
    pairs = [slice(2 * i, 2 * i + 2) for i in range(3)]
    same = [bool(torch.equal(out[p], cuda_kernels.attention(q[p], k[p], v[p], valid[p]))) for p in pairs]
    err = (out.float() - ref.float()).abs().max().item()
    tol = 2.0**-6 * ref.float().abs().max().item()
    occ = ext.attention_occupancy(1024, False)
    row["attention"] = {"B": 6, "valid": list(counts), "pairs_equal_B2": same, "max_abs_err": err, "tol": tol,
                        "blocks": 6 * 4 * 1024 // 64, **occ,
                        "ms_B6": device_ms(lambda: cuda_kernels.attention(q, k, v, valid), ("attention_mma_kernel",))[0],
                        "ms_B2": device_ms(lambda: cuda_kernels.attention(q[:2], k[:2], v[:2], valid[:2]),
                                           ("attention_mma_kernel",))[0]}
    if not (all(same) and err <= tol):
        bad.append(f"attention at B = 6: pairs equal to B = 2 {same}, max |err| {err} (<= {tol})")

    # --- Sinkhorn: three lanes through the batched transport ---------------
    lanes = [transport_inputs(n0, n1) for n0, n1 in ((1000, 1000), (950, 1000), (1000, 880))]
    scores = torch.stack([t[0] for t in lanes])
    v0, v1 = torch.stack([t[1] for t in lanes]), torch.stack([t[2] for t in lanes])
    alpha = lanes[0][3]
    cuda_ext.LAUNCHES.clear()
    Z = cuda_kernels.log_optimal_transport_kernel(scores, v0, v1, alpha, 20)
    launches = cuda_ext.LAUNCHES.get("sinkhorn", 0)
    same = [bool(torch.equal(Z[i], cuda_kernels.log_optimal_transport_kernel(*lanes[i][:3], alpha, 20)))
            for i in range(3)]
    Zp = cuda_kernels.log_optimal_transport_kernel(scores, v0, v1, alpha, 20, plain=True)
    err = max(((Z[i] - Zp[i]).abs() * (Zp[i] > -1e8)).max().item() for i in range(3))
    row["sinkhorn"] = {"lanes": 3, "launches": launches, "lanes_equal_single": same, "max_abs_err": err, "tol": 1e-4}
    if not (all(same) and err <= 1e-4 and launches == 3):
        bad.append(f"sinkhorn over 3 lanes: lanes equal to a single call {same}, {launches} launches, max |err| {err}")

    # --- pose GN: B = 6 against each lane's B = 2 --------------------------
    problems = [pose_problem(1024, False, seed=31), pose_problem(1024, False, seed=32, outliers=False),
                pose_problem(1024, False, seed=33)]
    R0, t0, obs, geom = pose_batch([p for p in problems for _ in range(2)], FRAME_STEP_STARTS * 3)
    out = optimize_pose(R0, t0, obs, *geom)
    ref_R, ref_t, ref_inl, steps = optimize_pose_plain(R0, t0, obs.X, obs.uv, obs.valid, *geom, full_schedule=True)
    _, _, _, short_steps = optimize_pose_plain(R0, t0, obs.X, obs.uv, obs.valid, *geom)
    same = []
    for p in pairs:
        two = optimize_pose(R0[p], t0[p], type(obs)(*(f[p] for f in obs)), *geom)
        same.append(all(bool(torch.equal(a, b)) for a, b in zip(two, (out.R_cw[p], out.t_cw[p], out.inliers[p]))))
    err_R = (out.R_cw - ref_R).abs().max().item()
    err_t = (out.t_cw - ref_t).abs().max().item()
    agree = (out.inliers == ref_inl).float().mean().item()
    row["pose_gn"] = {"B": 6, "N": 1024, "lanes_equal_B2": same, "err_R": err_R, "err_t": err_t, "inlier_agree": agree,
                      "steps_plain_shortcuts": short_steps.tolist(),
                      "ms_B6": device_ms(lambda: optimize_pose(R0, t0, obs, *geom), ("pose_gn_kernel",))[0],
                      "ms_B2": device_ms(lambda: optimize_pose(R0[:2], t0[:2], type(obs)(*(f[:2] for f in obs)), *geom),
                                         ("pose_gn_kernel",))[0]}
    if not (all(same) and err_R <= 2e-5 and err_t <= 2e-4 and agree >= 0.99):
        bad.append(f"pose_gn at B = 6: lanes equal to B = 2 {same}, R {err_R} (<= 2e-5), t {err_t} (<= 2e-4), "
                   f"inliers {agree} (>= 0.99)")
    if len(set(tuple(short_steps[p].tolist()) for p in pairs)) < 2:
        bad.append(f"pose_gn at B = 6: the lanes did not run different steps ({short_steps.tolist()})")
    emit(row)
    if bad:
        raise AssertionError("multi_seq batch invariance: " + "; ".join(bad))


def multi_seq_engine(S, kernels=True, compute_dtype=None, seed=None):
    """``MultiSequenceVO`` with ``production_engine()``'s configuration;
    ``compute_dtype`` and ``seed`` (``runtime.seed``: the lanes' and
    trackers' samplers) replace the configuration's."""
    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.parallel.multi_seq import MultiSequenceVO

    cfg = production_config()
    if compute_dtype is not None:
        cfg.runtime.compute_dtype = compute_dtype
    if seed is not None:
        cfg.runtime.seed = seed
    return MultiSequenceVO(cfg, make_pinhole(W, H, FX, FX, W / 2, H / 2), S, device="cuda", kernels=kernels)


def multi_seq_lanes_at(msvo, slots):
    """Give lane j of ``msvo`` the generator that lane ``slots[j]`` of a
    MultiSequenceVO built with the same configuration draws from, so that a
    scene draws the same sets in any slot and at any S."""
    import torch

    msvo.generators = [torch.Generator(device=msvo.device).manual_seed(msvo.cfg.runtime.seed + 1000 * (k + 1))
                       for k in slots]
    return msvo


def multi_seq_trace(msvo):
    """Wrap each lane's tracker so that every frame appends, per lane, what
    the frame was: ``s`` the state it began in (``i`` initialising, ``t``
    tracking), ``m`` the precomputed match's count, ``row`` the batched
    track row's match and inlier counts, ``own`` the inlier count of the
    lane's own two-program track (the fallback), ``cand`` the triangulated
    candidates of the reference keyframe, ``ad`` adopted, ``lost``, ``kf``
    a keyframe inserted, ``reloc``. Returns the per-lane lists."""
    import numpy as np

    logs = [[] for _ in msvo.trackers]
    for t, log in zip(msvo.trackers, logs):
        def process(bank, ts, _t=t, _log=log, _f=t.process, **k):
            e = {"s": "t" if _t.initialized else "i"}
            m, pt = k.get("precomputed_match"), k.get("precomputed_track")
            if m is not None:
                e["m"] = int(m.num_valid())
            if pt is not None:
                e["row"] = [int(pt[0]), int(pt[1])]
            cand = reference_candidates(_t)
            if cand is not None:
                e["cand"] = cand
            lost, reloc = _t.frames_lost, _t.relocalizations
            _log.append(e)
            out = _f(bank, ts, **k)
            e.update(ad=int(_t.adopted_track), lost=int(_t.frames_lost > lost), kf=int(out is not None),
                     reloc=int(_t.relocalizations > reloc))
            return out

        def track_frame(*a, _f=t._track_frame, _log=log, **k):
            out = _f(*a, **k)
            _log[-1].setdefault("own", []).append(int(out[0]))
            return out

        t.process, t._track_frame = process, track_frame
    return logs


def multi_seq_row_check(msvo):
    """Wrap ``msvo._track_batched`` so that every call also computes each
    lane's row with the single-lane ``fused_track_core`` on that lane's
    inputs and a copy of its generator taken just before the call, and
    counts the lanes whose batched row differs from it in any bit (a lane
    that reads another's matches, snapshot or draws, or a row written to
    another lane's slot). Returns the tally, {"calls", "lanes", "unequal"}."""
    import torch

    from ur_mvo_tpu_torch.parallel.multi_seq import lane
    from ur_mvo_tpu_torch.runtime.frontend import fused_track_core

    tally = {"calls": 0, "lanes": 0, "unequal": []}
    batched = msvo._track_batched
    cam, topt, rt, kf = msvo.camera, msvo.cfg.tracking_optimization, msvo.cfg.runtime, msvo.cfg.keyframe

    def checked(matches, banks, snapshots, generators=None, pnp_sets=None):
        states = [g.get_state() for g in generators]
        out = batched(matches, banks, snapshots, generators, pnp_sets)
        for i, state in enumerate(states):
            g = torch.Generator(device=msvo.device)
            g.set_state(state)
            kp = banks.kpts[i]
            uvr = torch.cat([kp, -torch.ones((kp.shape[0], 1), dtype=torch.float32, device=kp.device)], dim=1)
            one = fused_track_core(g, lane(matches, i), uvr, snapshots[i], msvo.K_mat, cam.fx, cam.fy, cam.cx,
                                   cam.cy, cam.bf, topt.mono_point, topt.stereo_point, rt.pnp_ransac_iterations,
                                   rt.pnp_reprojection_threshold, kf.min_num_match, 4.0 * kf.max_distance)[0]
            tally["lanes"] += 1
            if not torch.equal(one, out[i]):
                tally["unequal"].append([tally["calls"], i])
        tally["calls"] += 1
        return out

    msvo._track_batched = checked
    return tally


def multi_seq_witness(smi):
    """``--multi-seq-witness``: phase 14's S = 3 lanes (seeds 11-13, 24
    frames, deterministic algorithms) in bf16 on the kernels as the phase
    runs them, in float32 on the kernels and on the plain versions (the
    JAX package's MultiSequenceVO computes in float32 whatever the
    configuration says), in bf16 with two other ``runtime.seed`` (the
    lanes' samplers), each lane alone at S = 1 in bf16 with its S = 3
    lane's generator (its per-frame trace and keyframe poses beside its S =
    3 lane's), and six other scenes (seeds 14-19) in bf16. A line a
    run: each lane's health row and per-frame trace (``multi_seq_trace``)."""
    import numpy as np
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    scenes = multi_seq_scenes(ENGINE_SEEDS)

    def run(name, seeds, sc, slots=None, **kw):
        vo = multi_seq_engine(len(seeds), **kw)
        if slots is not None:
            multi_seq_lanes_at(vo, slots)
        logs = multi_seq_trace(vo)
        rows, _, _ = multi_seq_run(vo, sc, seeds)
        traj = vo.trajectories()
        for r, log in zip(rows, logs):
            r["trace"] = log
        emit({"phase": "multi_seq", "check": "witness", "run": name, "seeds": list(seeds), "runs": rows,
              "card": smi})
        return rows, traj

    base, base_traj = run("bf16", ENGINE_SEEDS, scenes)
    run("float32", ENGINE_SEEDS, scenes, compute_dtype="float32")
    run("float32_plain", ENGINE_SEEDS, scenes, compute_dtype="float32", kernels=False)
    for seed in (1, 2):
        run(f"bf16_runtime_seed_{seed}", ENGINE_SEEDS, scenes, seed=seed)
    alone = []
    for k, seed in enumerate(ENGINE_SEEDS):
        rows, traj = run(f"bf16_alone_{seed}", (seed,), [scenes[k]], slots=[k])
        same_trace = rows[0]["trace"] == base[k]["trace"]
        same_poses = all(np.array_equal(a, b) for a, b in zip(traj[0], base_traj[k])) and \
            len(traj[0][0]) == len(base_traj[k][0])
        alone.append({"seed": seed, "trace_equal_S3": same_trace, "keyframes_equal_S3": same_poses})
    emit({"phase": "multi_seq", "check": "witness_alone", "lanes": alone, "card": smi})
    others = tuple(range(14, 20))
    run("bf16_seeds_14_19", others, multi_seq_scenes(others))
    torch.use_deterministic_algorithms(False)


def multi_seq_scenes(seeds, n_frames=ENGINE_FRAMES):
    """The ``mono/3d`` scenes (images, T_wc) of the seeds, cut to ``n_frames``."""
    from ur_mvo_tpu_torch.utils.synthscene import render_sequence

    return [tuple(a[:n_frames] for a in render_sequence(ENGINE_FRAMES, H, W, FX, seed=s, n_planes=3,
                                                          z_background=6.0)[:2]) for s in seeds]


def multi_seq_run(msvo, scenes, seeds, per_frame_launches=False):
    """Step the lanes lock-step through their scenes. Returns a row a lane
    (phase 8's health fields and the keyframe ATE), the host ms of each
    lock-step frame and, with ``per_frame_launches``, each frame's launch
    counts beside what the frame did (lanes tracking, rows adopted, the
    views' batched calls at S = 1, relocalizations)."""
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops import cuda_ext
    from ur_mvo_tpu_torch.utils.metrics import ate_rmse

    S, n = len(scenes), len(scenes[0][0])
    per_frame, frames, returned, init_at = [], [], [0] * S, [None] * S
    for i in range(n):
        before = (dict(cuda_ext.LAUNCHES), dict(msvo.view_calls), sum(t.relocalizations for t in msvo.trackers),
                  sum(t.frames_lost for t in msvo.trackers))
        t0 = time.perf_counter()
        out = msvo.process_batch(np.stack([sc[0][i] for sc in scenes]), [i / FPS] * S)
        torch.cuda.synchronize()
        per_frame.append(1e3 * (time.perf_counter() - t0))
        for s, pose in enumerate(out):
            returned[s] += pose is not None and bool(np.isfinite(pose).all())
            if init_at[s] is None and msvo.trackers[s].initialized:
                init_at[s] = i
        if per_frame_launches:
            frames.append({"frame": i, **msvo.last_frame,
                           "launches": {k: v - before[0].get(k, 0) for k, v in cuda_ext.LAUNCHES.items()
                                        if v != before[0].get(k, 0)},
                           "view_calls": {k: v - before[1].get(k, 0) for k, v in msvo.view_calls.items()
                                          if v != before[1].get(k, 0)},
                           "relocalizations": sum(t.relocalizations for t in msvo.trackers) - before[2],
                           "frames_lost": sum(t.frames_lost for t in msvo.trackers) - before[3]})
    torch.cuda.synchronize()
    rows = []
    for s, (seed, (kts, kR, kt)) in enumerate(zip(seeds, msvo.trajectories())):
        T_wc = scenes[s][1]
        idx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, len(T_wc) - 1)
        tr = msvo.trackers[s]
        rows.append({"seed": seed, "initialised_at_frame": init_at[s], "keyframes": len(kts),
                     "keyframe_frame_ids": idx.tolist(), "frames_lost": tr.frames_lost,
                     "relocalizations": tr.relocalizations, "keyframe_poses_returned": returned[s],
                     "poses_finite": bool(np.isfinite(kR).all() and np.isfinite(kt).all()),
                     "keyframe_ate": float(ate_rmse(np.asarray(kt), T_wc[idx][:, :3, 3], align=True, correct_scale=True))
                     if len(kts) >= 3 else None})
    return rows, per_frame, frames


def multi_seq_health(rows, what):
    """Phase 8's health limits, lane by lane, for every lane that
    initialised (a lane that never did is reported beside them,
    ``multi_seq_phase``). With a per-frame trace (``multi_seq_trace``), a
    frame lost while the lane's reference keyframe held fewer than
    ``MULTI_SEQ_COLLAPSED`` triangulated points is counted apart as lost to
    a collapsed map, and only the other lost frames are held to the limit:
    from such a reference no pose can be solved, and the JAX package's
    MultiSequenceVO loses every frame after the same collapse (ROADMAP
    C11)."""
    bad = []
    for r in rows:
        where = f"multi_seq ({what}, seed {r['seed']})"
        if r["initialised_at_frame"] is None:
            continue
        if "trace" in r:
            r["frames_lost_collapsed"] = sum(e["lost"] and e.get("cand", 0) < MULTI_SEQ_COLLAPSED for e in r["trace"])
        lost = r["frames_lost"] - r.get("frames_lost_collapsed", 0)
        if r["keyframes"] < MIN_KEYFRAMES:
            bad.append(f"{where}: {r['keyframes']} keyframes (>= {MIN_KEYFRAMES})")
        elif lost > MAX_FRAMES_LOST:
            bad.append(f"{where}: {lost} frames lost from a map it could track (<= {MAX_FRAMES_LOST})")
        elif not r["poses_finite"]:
            bad.append(f"{where}: a keyframe pose is not finite")
    return bad


def multi_seq_launch_check(frames, S, layers):
    """Per lock-step frame: the stage kernels once a stage, attention once
    a GNN layer, Sinkhorn once a lane, each again for every call a lane's
    view made at S = 1; pose GN exactly once for the batched track where a
    lane tracks, plus once for every ``optimize_pose`` call of the lanes'
    own flows (``Tracker.pose_calls``: a lane whose tracker did not adopt
    its row, a place verification). Returns the faults and the tracking
    frames on which every tracking lane adopted its row."""
    bad, clean = [], 0
    for f in frames:
        L, views = f["launches"], f["view_calls"]
        want = {"stage1_conv": 1 + views.get("extract", 0), "stage_conv": 2 * (1 + views.get("extract", 0)),
                "attention": layers * (1 + views.get("match", 0)), "sinkhorn": S + views.get("match", 0),
                "pose_gn": (f["track_lanes"] > 0) + f["lane_pose_calls"]}
        got = {k: L.get(k, 0) for k in want}
        if got != want:
            bad.append(f"frame {f['frame']}: launches {got}, expected {want}")
        clean += f["track_lanes"] > 0 and f["adopted"] == f["track_lanes"]
    return bad, clean


def multi_seq_phase(smi):
    """Phase 14: ``MultiSequenceVO`` on the card. The kernels' batch
    invariance at the lock-step shapes; then S = 3 lanes (the ``mono/3d``
    scenes of seeds 11-13, 24 frames each) under deterministic algorithms,
    launch counts reset just before: every lane that initialises held to
    phase 8's health (``multi_seq_health``), the lanes' keyframe ATEs
    printed beside the single-stream engine's and the JAX package's
    (``MULTI_SEQ_JAX``), the launches of every lock-step frame checked
    (``multi_seq_launch_check``) and at least ``MULTI_SEQ_MIN_CLEAN_SHARE``
    of the tracking frames with every tracking lane on its batched row;
    the same lanes rotated in the batch, each lane's trace and keyframes
    equal to its own and every batched track row equal to the single-lane
    core's (``multi_seq_row_check``); the same lanes through the plain
    versions; host ms a lock-step frame at S = 1, 3 and 6 and the device's
    busy share of lock-step frames at S = 3. Returns the path's launches."""
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops import cuda_ext

    failures = []
    try:
        multi_seq_batch_invariance(smi)
    except AssertionError as e:
        emit({"phase": "multi_seq", "check": "batch_invariance", "failed": str(e)})
        failures.append("batch_invariance")

    # --- the path: S = 3, checked ---------------------------------------
    torch.use_deterministic_algorithms(True, warn_only=True)
    scenes = multi_seq_scenes(ENGINE_SEEDS)
    msvo = multi_seq_engine(len(ENGINE_SEEDS))
    layers = len(msvo.superglue.layers)
    logs = multi_seq_trace(msvo)
    cuda_ext.LAUNCHES.clear()
    rows, _, frames = multi_seq_run(msvo, scenes, ENGINE_SEEDS, per_frame_launches=True)
    launches = dict(cuda_ext.LAUNCHES)
    traj = msvo.trajectories()
    MULTI_SEQ_REF.update(logs=logs, traj=traj)
    for r, log in zip(rows, logs):
        r["trace"] = log
    if not SINGLE_STREAM_ROWS:  # phase 8 did not run (--only-multi-seq): the single stream on the same seeds
        one = production_engine()
        SINGLE_STREAM_ROWS.extend(engine_run(one, s)[0] for s in ENGINE_SEEDS)
        one.shutdown()
    single = SINGLE_STREAM_ROWS
    for r in rows:
        one = next((x for x in single if x["seed"] == r["seed"]), {})
        r["single_stream_keyframe_ate"] = one.get("keyframe_ate")
        r["jax_multi_seq"] = MULTI_SEQ_JAX.get(r["seed"])
    bad = multi_seq_health(rows, "kernels")
    initialised = [r["seed"] for r in rows if r["initialised_at_frame"] is not None]
    if not initialised:
        bad.append("multi_seq: no lane initialised")
    if not any(f["track_lanes"] for f in frames):
        bad.append("multi_seq: no lane reached tracking: the batched track never ran")
    kf_ates = [r["keyframe_ate"] for r in rows if r["keyframe_ate"] is not None]
    launch_bad, clean = multi_seq_launch_check(frames, len(ENGINE_SEEDS), layers)
    tracking = sum(1 for f in frames if f["track_lanes"])
    missing = [k for k in ENGINE_KERNELS if launches.get(k, 0) == 0]
    if missing:
        bad.append(f"multi_seq: kernels of the path never launched: {missing}")
    if clean < MULTI_SEQ_MIN_CLEAN_SHARE * tracking:
        bad.append(f"multi_seq: {clean} of {tracking} tracking frames had every tracking lane on its batched row "
                   f"(>= {MULTI_SEQ_MIN_CLEAN_SHARE} of them)")
    emit({"phase": "multi_seq", "check": "lanes", "S": len(ENGINE_SEEDS), "frames": ENGINE_FRAMES, "runs": rows,
          "mean_keyframe_ate_of_the_lanes_with_one": statistics.mean(kf_ates) if kf_ates else None,
          "single_stream_mean_keyframe_ate": statistics.mean(
              x["keyframe_ate"] for x in single if x.get("keyframe_ate") is not None),
          "lanes_held_to_health": initialised,
          "lanes_never_initialised": [r["seed"] for r in rows if r["initialised_at_frame"] is None],
          "launches": launches, "gnn_layers": layers, "tracking_frames": tracking,
          "frames_every_tracking_lane_adopted": clean, "min_share": MULTI_SEQ_MIN_CLEAN_SHARE,
          "frames_with_fallbacks": [f for f in frames if f["track_lanes"] and f["adopted"] < f["track_lanes"]],
          "launch_faults": launch_bad, "card": smi})
    bad += launch_bad

    # --- every lane its own: the same lanes rotated in the batch ----------
    # each scene keeps its lane generator; every lane's per-frame trace and
    # keyframe poses must equal its own in the run above bit for bit, and
    # every batched track row the single-lane core's on its lane's inputs
    rot = ENGINE_SEEDS[1:] + ENGINE_SEEDS[:1]
    vo = multi_seq_lanes_at(multi_seq_engine(len(rot)), [ENGINE_SEEDS.index(s) for s in rot])
    logs_r = multi_seq_trace(vo)
    tally = multi_seq_row_check(vo)
    multi_seq_run(vo, [scenes[ENGINE_SEEDS.index(s)] for s in rot], rot)
    traj_r = vo.trajectories()
    own = []
    for j, seed in enumerate(rot):
        k = ENGINE_SEEDS.index(seed)
        own.append({"seed": seed, "slot": j, "slot_before": k, "trace_equal": logs_r[j] == logs[k],
                    "keyframes_equal": len(traj_r[j][0]) == len(traj[k][0]) and all(
                        np.array_equal(a, b) for a, b in zip(traj_r[j], traj[k]))})
    emit({"phase": "multi_seq", "check": "lanes_rotated", "lanes": own, "track_calls": tally["calls"],
          "rows_checked": tally["lanes"], "rows_unequal_single_lane": tally["unequal"], "card": smi})
    if not all(o["trace_equal"] and o["keyframes_equal"] for o in own):
        bad.append(f"multi_seq: a lane moved with its slot in the batch: {own}")
    if tally["unequal"] or not tally["calls"]:
        bad.append(f"multi_seq: batched track rows unequal to the single-lane core's "
                   f"([call, lane]): {tally['unequal']} of {tally['lanes']}")
    del vo
    if bad:
        emit({"phase": "multi_seq", "check": "lanes", "failed": bad})
        failures.append("lanes")
    torch.use_deterministic_algorithms(False)

    # --- the plain versions ----------------------------------------------
    plain = multi_seq_engine(len(ENGINE_SEEDS), kernels=False)
    plain_logs = multi_seq_trace(plain)
    cuda_ext.LAUNCHES.clear()
    plain_rows, plain_ms, _ = multi_seq_run(plain, scenes, ENGINE_SEEDS)
    plain_launches = dict(cuda_ext.LAUNCHES)
    for r, log in zip(plain_rows, plain_logs):
        r["trace"] = log
    emit({"phase": "multi_seq", "check": "plain", "runs": plain_rows, "health_faults": multi_seq_health(plain_rows, "plain"),
          "kernel_launches": plain_launches, "ms_per_frame_median": statistics.median(plain_ms)})
    if plain_launches:
        failures.append("plain")
        emit({"phase": "multi_seq", "check": "plain", "failed": f"kernels=False launched kernels: {plain_launches}"})
    del plain

    # --- times: S = 1, 3, 6, as a user runs it ----------------------------
    times = {}
    # S = 1 on seed 13, whose lane tracks: the lane of seed 11 never
    # initialises in this MultiSequenceVO (nor in the JAX package's)
    for seeds, n in (((13,), ENGINE_FRAMES), (ENGINE_SEEDS, ENGINE_FRAMES), (tuple(range(11, 17)), MULTI_SEQ_S6_FRAMES)):
        S = len(seeds)
        sc = [scenes[ENGINE_SEEDS.index(s)] for s in seeds] if set(seeds) <= set(ENGINE_SEEDS) \
            else multi_seq_scenes(seeds, n)
        vo = multi_seq_engine(S)
        vo.timer.reset()
        trows, ms, _ = multi_seq_run(vo, sc, seeds)
        steady = ms[max((r["initialised_at_frame"] or 0) for r in trows) + 1:] or ms
        times[f"S={S}"] = {"frames": n, "seeds": list(seeds), "host_ms_median": statistics.median(ms),
                           "host_ms_median_all_tracking": statistics.median(steady), "host_ms_max": max(ms),
                           "fps_over_lanes": S * 1e3 / statistics.median(steady),
                           "per_stage": {k: {"count": v["count"], "mean_ms": v["mean_ms"]}
                                         for k, v in vo.timer.summary().items()},
                           "lanes_initialised": sum(r["initialised_at_frame"] is not None for r in trows)}
    emit({"phase": "multi_seq", "check": "times", "unit": "host ms a lock-step frame", **times, "card": smi})

    # --- the device's share of lock-step frames at S = 3 ------------------
    vo = multi_seq_engine(len(ENGINE_SEEDS))
    it = iter(range(ENGINE_FRAMES))

    def step():
        i = next(it)
        vo.process_batch(np.stack([sc[0][i] for sc in scenes]), [i / FPS] * len(scenes))

    for _ in range(11):  # through initialisation; the profiled frames track
        step()
    calls = 4
    dev, host, wall = profile_device(step, calls)
    busy = sum(dev.values()) / 1e3
    emit({"phase": "multi_seq", "check": "device_share", "S": len(scenes), "frames": list(range(12, 12 + calls)),
          "unit": "ms a lock-step frame", "wall": wall / calls, "device_busy": busy / calls,
          "idle_share": 1.0 - busy / wall, "device_launches": host.pop("device records", 0) / calls,
          "top_kernels": [[k[:70], v / 1e3 / calls] for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:8]],
          "card": smi})
    if failures:
        raise AssertionError(f"multi_seq: checks failed: {failures}")
    return {"multi_seq": launches}


# ---------------------------------------------------------------------------
# Phase 15: the mesh paths (parallel/mesh, dist_matching, dist_ba,
# MultiSequenceVO(mesh=), Backend.global_optimize(mesh=))
# ---------------------------------------------------------------------------

def mesh_matcher_pairs(msvo, scenes):
    """The matcher check's pairs: frames (0, 1) and (0, 2) of each scene,
    extracted by ``msvo`` (6 pairs: the mesh sizes 1, 2 and 3 divide it)."""
    from ur_mvo_tpu_torch.parallel.multi_seq import lane, stack_lanes

    banks = [msvo._extract_batched(sc[0][:3]) for sc in scenes]
    return (stack_lanes([lane(b, 0) for b in banks for _ in (1, 2)]),
            stack_lanes([lane(b, j) for b in banks for j in (1, 2)]))


def mesh_inputs(smi, workdir):
    """Phase 15's inputs, pickled to ``workdir/inputs.pkl``, and the
    single-device references: phase 14's lanes (their traces and
    keyframes; run here when phase 14 did not), the unsharded batched match
    of the matcher's pairs, phase 12's 65,536-point problem and its
    ``bundle_adjust`` (``"auto"``: the sorted kernel; phase 12's solution
    where it ran), phase 9's long map and its ``global_optimize()`` (run
    here when phase 9 did not), and the long map after the pose graph alone
    (``global_optimize(full_ba=False)``): what the full BA must improve."""
    import copy
    import pickle

    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops.ba import BAConfig, bundle_adjust
    from ur_mvo_tpu_torch.ops.matching import decode_assignment
    from ur_mvo_tpu_torch.parallel.multi_seq import stack_lanes
    from ur_mvo_tpu_torch.runtime.backend import Backend
    from ur_mvo_tpu_torch.weights import ba_problem_from_numpy

    torch.use_deterministic_algorithms(True, warn_only=True)
    scenes = multi_seq_scenes(ENGINE_SEEDS)
    if not MULTI_SEQ_REF:
        msvo = multi_seq_engine(len(ENGINE_SEEDS))
        logs = multi_seq_trace(msvo)
        multi_seq_run(msvo, scenes, ENGINE_SEEDS)
        MULTI_SEQ_REF.update(logs=logs, traj=msvo.trajectories())
    if not LONG_MAP_REF:
        long_map_global_optimize(smi, production_engine(long_run=True).tracker.backend)
    camera, bcfg, ocfg = LONG_MAP_REF["template"]
    st = copy.deepcopy(LONG_MAP_REF["store"])
    b = Backend(camera, bcfg, ocfg, store=st, keypoints_per_frame=st.cfg.keypoints_per_frame, device="cuda")
    b.global_optimize(full_ba=False)
    pose_graph = {f: getattr(st, f).copy() for f in ("kf_R", "kf_t", "mp_pos")}
    msvo = multi_seq_engine(1)
    b0, b1 = mesh_matcher_pairs(msvo, scenes)
    sg_cfg = msvo.cfg.superglue
    with torch.no_grad():
        Z = msvo.superglue.match_scores(b0, b1, sg_cfg.image_width, sg_cfg.image_height,
                                        sinkhorn_iterations=sg_cfg.sinkhorn_iterations, num_heads=msvo.num_heads)
    match_ref = stack_lanes([decode_assignment(Z[i], b0.valid[i], b1.valid[i], msvo.match_threshold)
                             for i in range(Z.shape[0])])
    P, per, F = GLOBAL_BA
    fields, _, geom = global_ba_problem(P, per, F)
    if not GLOBAL_BA_REF:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = bundle_adjust(ba_problem_from_numpy(fields, MESH_DEVICE), *geom, BAConfig(max_free_frames=F, tol=0.0))
        torch.cuda.synchronize()
        GLOBAL_BA_REF.update(result=ref, seconds=time.perf_counter() - t0)
    ref, ba_s = GLOBAL_BA_REF["result"], GLOBAL_BA_REF["seconds"]
    torch.use_deterministic_algorithms(False)
    key = fields[6] * P + fields[7]  # (frame, point): each point's observers are distinct frames
    inp = {"scenes": scenes, "pairs": tuple(tuple(f.cpu() for f in b) for b in (b0, b1)),
           "ba": (fields, geom, F), "long": {k: LONG_MAP_REF[k] for k in ("store", "template")}}
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    return {"match": tuple(f.cpu().numpy() for f in match_ref), "pose_graph": pose_graph,
            "ba": {"R": ref.R_wc.cpu().numpy(), "t": ref.t_wc.cpu().numpy(), "X": ref.X.cpu().numpy(),
                   "inlier_by_key": ref.obs_inlier.cpu().numpy()[np.argsort(key)], "seconds": ba_s}}


def mesh_rank(rank, world, backend, workdir):
    """``--mesh-rank R WORLD BACKEND DIR``: one rank of phase 15 on
    ``cuda:0``, launch counts reset just before each path: its lanes of
    ``MultiSequenceVO(mesh)`` (24 frames of phase 14's scenes, each lane
    with its phase-14 slot's generator, a per-frame trace a lane), the
    matcher's pairs through ``make_batched_matcher``, the 65,536-point
    problem through ``shard_problem`` and ``dist_bundle_adjust``, and
    ``global_optimize(mesh)`` on the long map; its results pickled to
    ``DIR/w{WORLD}_rank{R}.pkl`` and a JSON line of its launches and
    seconds. Under deterministic algorithms, as phase 14."""
    import pickle

    import numpy as np
    import torch

    from ur_mvo_tpu_torch.ops import cuda_ext
    from ur_mvo_tpu_torch.ops.ba import BAConfig
    from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
    from ur_mvo_tpu_torch.parallel import mesh as tmesh
    from ur_mvo_tpu_torch.parallel.dist_ba import dist_bundle_adjust, shard_problem
    from ur_mvo_tpu_torch.parallel.dist_matching import make_batched_matcher
    from ur_mvo_tpu_torch.parallel.multi_seq import MultiSequenceVO
    from ur_mvo_tpu_torch.runtime.backend import Backend
    from ur_mvo_tpu_torch.weights import ba_problem_from_numpy

    t_start = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = tmesh.init_distributed(backend, init_method=f"file://{workdir}/rendezvous_w{world}", world_size=world,
                                 rank=rank, device=MESH_DEVICE)
    mesh = tmesh.make_mesh(world)
    cuda_ext.extension()
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    slots = next(lanes for w, _, lanes in MESH_WORLDS if w == world)
    out = {"rank": rank, "world": world, "backend": backend, "lanes": {}, "launches": {}, "seconds": {},
           "setup_s": time.perf_counter() - t_start}

    def run(name, fn):
        torch.cuda.synchronize()
        cuda_ext.LAUNCHES.clear()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = dict(cuda_ext.LAUNCHES)
        return r

    # --- MultiSequenceVO(mesh): S lanes, S / world a rank ------------------
    from ur_mvo_tpu_torch.camera import make_pinhole

    cfg = production_config()
    cam = make_pinhole(W, H, FX, FX, W / 2, H / 2)
    msvo = MultiSequenceVO(cfg, cam, len(slots), mesh=mesh, device=dev)
    multi_seq_lanes_at(msvo, [slots[i] for i in msvo.lanes])
    logs = multi_seq_trace(msvo)
    scenes = [inp["scenes"][k] for k in slots]

    def lanes():
        return [msvo.process_batch(np.stack([sc[0][i] for sc in scenes]), [i / FPS] * len(scenes))
                for i in range(ENGINE_FRAMES)]

    out["poses"] = run("multi_seq", lanes)
    out["traj"] = msvo.trajectories()
    out["lanes"] = {slots[i]: log for i, log in zip(msvo.lanes, logs)}
    try:
        MultiSequenceVO(cfg, cam, world + 1, mesh=mesh, device=dev)
        out["odd_S"] = None if world == 1 else "built"
    except ValueError as e:
        out["odd_S"] = str(e)

    # --- make_batched_matcher on the pairs ---------------------------------
    b0, b1 = (FeatureBank(*(t.to(dev) for t in b)) for b in inp["pairs"])
    sg_cfg = cfg.superglue
    match = make_batched_matcher(msvo.superglue, mesh, sg_cfg.image_width, sg_cfg.image_height,
                                 sg_cfg.sinkhorn_iterations, msvo.match_threshold, msvo.num_heads)
    m = run("match", lambda: match(b0, b1))
    out["match"] = tuple(f.cpu().numpy() for f in m)
    del msvo

    # --- dist_bundle_adjust on the 65,536-point problem --------------------
    fields, geom, F = inp["ba"]
    P = fields[4].shape[0]
    prob = ba_problem_from_numpy(fields, dev)

    def ba():
        prob_s, perm = shard_problem(prob, world)
        return prob_s, perm, dist_bundle_adjust(prob_s, mesh, *geom, BAConfig(max_free_frames=F, tol=0.0))

    prob_s, perm, res = run("dist_ba", ba)
    perm_t = torch.from_numpy(perm).to(dev)
    key = (prob_s.obs_frame * P + perm_t[prob_s.obs_point]).cpu().numpy()
    valid = prob_s.obs_valid.cpu().numpy()
    out["ba"] = {"R": res.R_wc.cpu().numpy(), "t": res.t_wc.cpu().numpy(),
                 "X": torch.empty_like(res.X).index_put_((perm_t,), res.X).cpu().numpy(),
                 "inlier_by_key": res.obs_inlier.cpu().numpy()[valid][np.argsort(key[valid])],
                 "observations_padded": int(prob_s.obs_frame.shape[0])}
    del prob, prob_s, res

    # --- global_optimize(mesh) on the long map ------------------------------
    camera, bcfg, ocfg = inp["long"]["template"]
    store = inp["long"]["store"]
    b = Backend(camera, bcfg, ocfg, store=store, keypoints_per_frame=store.cfg.keypoints_per_frame, device=dev)
    run("global_optimize", lambda: b.global_optimize(mesh=mesh))
    out["long"] = {"full_ba": b.last_full_ba, **{f: getattr(b.store, f).copy() for f in ("kf_R", "kf_t", "mp_pos")}}

    # --- the mesh BA's all_reduce traffic a LM step (cli.bench_scaling) -----
    from ur_mvo_tpu_torch.cli.bench_scaling import count_all_reduce

    out["all_reduce"] = run("all_reduce_count", lambda: count_all_reduce(mesh, dev))
    out["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(workdir, f"w{world}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    emit({"phase": "mesh_rank", "world": world, "rank": rank, "backend": backend, "lanes": list(out["lanes"]),
          "launches": out["launches"], "seconds": out["seconds"], "setup_s": out["setup_s"]})
    torch.distributed.destroy_process_group()


def reprojection_rms(fields, store, order, camera):
    """RMS pixel error of every observation of the map's good points in the
    keyframes of ``order``, at ``fields``' poses and points: a point
    written back to another point's row shows here."""
    import numpy as np

    sub = store.obs_slot[:, order]
    p, k = np.nonzero((sub >= 0) & (store.mp_good & ~store.mp_bad)[:, None])
    slot = order[k]
    uv = store.kf_kpts[slot, sub[p, k], :2]
    pc = np.einsum("nji,nj->ni", fields["kf_R"][slot], fields["mp_pos"][p] - fields["kf_t"][slot])
    proj = np.stack([camera.fx * pc[:, 0] / pc[:, 2] + camera.cx, camera.fy * pc[:, 1] / pc[:, 2] + camera.cy], 1)
    return float(np.sqrt(np.mean(np.sum((proj - uv) ** 2, 1))))


def mesh_compare(out, refs, slots):
    """One rank's results against the single-device references: its lanes'
    traces and every lane's keyframes bit for bit with phase 14's, its
    gathered matches bit for bit with the unsharded batched match, the
    65,536-point BA within phase 7's limits of ``bundle_adjust`` (R 1e-3, t
    1e-3, X 5e-3, inlier verdicts on >= 99%), the kernels of the lanes and
    the match launched, no point-reduce kernel in a shard's BA. The long
    map's ``global_optimize(mesh)``: its reprojection RMS within 1% of
    ``global_optimize()``'s; its keyframe ATE, with and without scale
    correction, at most twice the single device's, and with it below that
    of the pose graph alone. Returns the row and its faults."""
    import numpy as np

    ms = MULTI_SEQ_REF
    lanes = {slot: log == ms["logs"][slot] for slot, log in out["lanes"].items()}
    keyframes = [len(tr[0]) == len(ms["traj"][k][0]) and all(np.array_equal(a, b) for a, b in zip(tr, ms["traj"][k]))
                 for tr, k in zip(out["traj"], slots)]
    match = all(np.array_equal(a, b) for a, b in zip(out["match"], refs["match"]))
    ba, rb = out["ba"], refs["ba"]
    ba_d = {"R": float(np.abs(ba["R"] - rb["R"]).max()), "t": float(np.abs(ba["t"] - rb["t"]).max()),
            "X": float(np.abs(ba["X"] - rb["X"]).max()),
            "inlier_agreement": float((ba["inlier_by_key"] == rb["inlier_by_key"]).mean())}
    from ur_mvo_tpu_torch.utils.metrics import ate_rmse

    lm, ref, lr = out["long"], LONG_MAP_REF["kernels"], LONG_MAP_REF
    order, used = lr["order"], lr["used"]

    def ate(fields):
        return {f"ate{tag}": float(ate_rmse(fields["kf_t"][order], lr["t_true"], align=True, correct_scale=cs))
                for tag, cs in (("", True), ("_no_scale", False))}

    cam = lr["template"][0]
    long_d = {"R": float(np.abs(lm["kf_R"][order] - ref["kf_R"][order]).max()),
              "t": float(np.abs(lm["kf_t"][order] - ref["kf_t"][order]).max()),
              "X": float(np.abs(lm["mp_pos"][used] - ref["mp_pos"][used]).max()),
              "X_median": float(np.median(np.abs(lm["mp_pos"][used] - ref["mp_pos"][used]).max(1))),
              "ate_before": lr["ate_before"], "mesh": ate(lm), "single_device": ate(ref),
              "pose_graph_alone": ate(refs["pose_graph"]),
              "rms_px_mesh": reprojection_rms(lm, lr["store"], order, cam),
              "rms_px_single_device": reprojection_rms(ref, lr["store"], order, cam)}
    path = {k: out["launches"]["multi_seq"].get(k, 0) + out["launches"]["match"].get(k, 0) for k in ENGINE_KERNELS}
    row = {"lane_traces_equal_phase14": lanes, "keyframes_equal_phase14": keyframes, "matches_equal_unsharded": match,
           "dist_ba_vs_bundle_adjust": ba_d, "long_map_vs_global_optimize": long_d, "long_full_ba": lm["full_ba"],
           "launches": out["launches"], "path_launches": path, "odd_S": out["odd_S"], "seconds": out["seconds"],
           "setup_s": out["setup_s"], "total_s": out["total_s"]}
    bad = []
    if not (all(lanes.values()) and all(keyframes)):
        bad.append(f"lanes unlike phase 14's: traces {lanes}, keyframes {keyframes}")
    if not match:
        bad.append("matches unlike the unsharded batched match")
    if not (ba_d["R"] <= 1e-3 and ba_d["t"] <= 1e-3 and ba_d["X"] <= 5e-3 and ba_d["inlier_agreement"] >= 0.99):
        bad.append(f"dist_ba vs bundle_adjust: {ba_d} (R 1e-3, t 1e-3, X 5e-3, inliers 0.99)")
    # the long map's gauge (only its first keyframes fixed) leaves a bending
    # mode that the full BA's summands (a shard's float32 against the sorted
    # route's bf16) and their order move by far more than phase 7's limits
    # (PERF.md, section 6, PR 14; phase 12's docstring): the map is held by
    # how well it fits its observations, its keyframes by the truth. Along
    # that mode the full BA gives up the metric scale of the pose graph on
    # both routes (the ATE without scale correction rises), so there the
    # mesh is held to the single device's alone
    long_d["within_phase7_limits"] = long_d["R"] <= 1e-3 and long_d["t"] <= 1e-3 and long_d["X"] <= 5e-3
    if not long_d["rms_px_mesh"] <= 1.01 * long_d["rms_px_single_device"]:
        bad.append(f"long map global_optimize(mesh): reprojection RMS {long_d['rms_px_mesh']} px against the "
                   f"single device's {long_d['rms_px_single_device']} px (1%)")
    for k in ("ate", "ate_no_scale"):
        m, pg, sd = long_d["mesh"][k], long_d["pose_graph_alone"][k], long_d["single_device"][k]
        if not (m <= 2 * sd and (m < pg or k == "ate_no_scale")):
            bad.append(f"long map global_optimize(mesh): keyframe {k} {m} (pose graph alone {pg}, single device {sd})")
    missing = [k for k, v in path.items() if v == 0]
    if missing:
        bad.append(f"kernels of the lanes and the match never launched: {missing}")
    reduce = {k: v for name in ("dist_ba", "global_optimize") for k, v in out["launches"][name].items()}
    if reduce:
        bad.append(f"a shard's BA launched kernels: {reduce}")
    if lm["full_ba"] is None or lm["full_ba"]["assembly"] != "dist" or lm["full_ba"]["world"] != out["world"]:
        bad.append(f"global_optimize(mesh)'s full BA: {lm['full_ba']}")
    if out["world"] > 1 and "do not split" not in str(out["odd_S"]):
        bad.append(f"MultiSequenceVO with S = {out['world'] + 1} on {out['world']} ranks: {out['odd_S']}")
    return row, bad


def mesh_phase(smi):
    """Phase 15: the mesh paths in ranks of their own, on the one card.
    The parent builds the inputs and the single-device references
    (:func:`mesh_inputs`), then starts each world of ``MESH_WORLDS`` (world
    1 over NCCL, world 2 over gloo with CUDA tensors, both ranks on
    ``cuda:0``), both worlds at once, every rank this script with
    ``--mesh-rank`` (:func:`mesh_rank`); a rank that fails or outlives
    ``MESH_DEADLINE_S`` fails the phase (the others are killed). Each
    rank's results against the references (:func:`mesh_compare`). Returns
    the launches of each rank's lanes and match."""
    import pickle
    import shutil

    import numpy as np

    workdir = os.path.join(REPO, "build", "mesh")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    refs = mesh_inputs(smi, workdir)
    inputs_s = time.perf_counter() - t0
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop("LOCAL_RANK", None)
    procs = []
    for world, backend, _ in MESH_WORLDS:
        for rank in range(world):
            log = open(os.path.join(workdir, f"w{world}_rank{rank}.log"), "w")
            procs.append((world, rank, log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(rank), str(world), backend, workdir],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)))
    bad, deadline = [], time.monotonic() + MESH_DEADLINE_S
    try:
        for world, rank, _, p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                bad.append(f"world {world} rank {rank}: not done within {MESH_DEADLINE_S} s")
                break
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    ranks_s = time.perf_counter() - t0 - inputs_s
    launches, outs = {}, {}
    for world, rank, _, p in procs:
        with open(os.path.join(workdir, f"w{world}_rank{rank}.log")) as f:
            text = f.read()
        for line in text.splitlines():
            if line.startswith('{"phase": "mesh_rank"'):
                print(line, flush=True)
        if p.returncode != 0:
            bad.append(f"world {world} rank {rank} exited {p.returncode}")
            print(f"--- world {world} rank {rank} (exit {p.returncode}), the end of its output:\n{text[-3000:]}",
                  file=sys.stderr, flush=True)
            continue
        with open(os.path.join(workdir, f"w{world}_rank{rank}.pkl"), "rb") as f:
            outs[world, rank] = pickle.load(f)
    for world, backend, slots in MESH_WORLDS:
        for rank in range(world):
            if (world, rank) not in outs:
                continue
            row, faults = mesh_compare(outs[world, rank], refs, slots)
            emit({"phase": "mesh", "world": world, "backend": backend, "rank": rank, "lanes_phase14_slots": list(slots),
                  **row, "faults": faults, "card": smi})
            bad += [f"world {world} rank {rank}: {f}" for f in faults]
            launches[f"mesh/w{world}" + (f"/r{rank}" if world > 1 else "")] = row["path_launches"]
        counts = [outs[world, r]["all_reduce"] for r in range(world) if (world, r) in outs]
        if counts:
            c, terms = counts[0], counts[0]["packed_terms"]
            emit({"phase": "mesh", "check": "all_reduce", "world": world, "backend": backend,
                  "problem": c["problem"], "lm_steps": c["lm_steps"],
                  "ranks": [{k: x[k] for k in ("rank", "all_reduce_calls", "all_reduce_bytes")} for x in counts],
                  "calls_a_step": c["calls_a_step"], "bytes_a_step": c["bytes_a_step"], "packed_terms": terms,
                  "jax_source": c["jax_source"], "seconds_not_a_rate": [x["seconds_not_a_rate"] for x in counts],
                  "card": smi})
            for x in counts:
                if (x["all_reduce_calls"], x["all_reduce_bytes"]) != (terms["calls"], terms["bytes"]):
                    bad.append(f"world {world} rank {x['rank']}: all_sum counted {x['all_reduce_calls']} calls, "
                               f"{x['all_reduce_bytes']} bytes; the packed terms give {terms['calls']}, "
                               f"{terms['bytes']}")
        if world > 1 and all((world, r) in outs for r in range(world)):
            same = all(np.array_equal(outs[world, 0][k][f], outs[world, r][k][f]) for r in range(1, world)
                       for k, fs in (("ba", ("R", "t", "X")), ("long", ("kf_R", "kf_t", "mp_pos"))) for f in fs)
            if not same:
                bad.append(f"world {world}: the ranks' BA results differ")
    emit({"phase": "mesh", "check": "seconds", "inputs_and_references": inputs_s, "ranks_wall": ranks_s,
          "single_device_global_ba_s": refs["ba"]["seconds"], "card": smi})
    if bad:
        raise AssertionError("mesh: " + "; ".join(bad))
    return launches


# ---------------------------------------------------------------------------
# Phase 16: the sequence entry points (chunked tracking, the command line)
# ---------------------------------------------------------------------------

def counted_syncs(fn, sites):
    """``fn()``'s result; adds to ``sites`` (a Counter) the host syncs it
    made by the line of Python that made them (every read of a device value
    on the host: ``torch.cuda.set_sync_debug_mode``'s warnings)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites.update(f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
                 if "synchronizing" in str(w.message))
    return out


class ChunkLaunches:
    """The kernel launches made inside ``Tracker.process_chunk`` calls (the
    chunk path's own), wrapped on this engine."""

    def __init__(self, vo):
        from ur_mvo_tpu_torch.ops import cuda_ext

        self.counts, tracker, process_chunk = {}, vo.tracker, vo.tracker.process_chunk

        def counted(*a, **k):
            before = dict(cuda_ext.LAUNCHES)
            try:
                return process_chunk(*a, **k)
            finally:
                for name, n in cuda_ext.LAUNCHES.items():
                    self.counts[name] = self.counts.get(name, 0) + n - before.get(name, 0)

        tracker.process_chunk = counted


def sequence_run(vo, seed, scene):
    """Reset the engine and feed it one scene through
    ``UR_MVO.process_sequence`` (blocks of ``runtime.chunk_frames``),
    pairing the emitted poses with timestamps as ``run_engine`` does (the
    frame that initialised is the first that emits); scored as
    ``engine_run``, with the host seconds of the whole sequence and the
    tracker's chunk counts."""
    import torch

    frames, T_wc = scene
    vo.reset()
    t0 = time.perf_counter()
    outs = vo.process_sequence(frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stamps, poses, pending, init_at = [], [], [], None
    for i, out in enumerate(outs):
        pending.append(i / FPS)
        if out:
            stamps.extend(pending[-len(out):])
            poses.extend(out)
            pending.clear()
            init_at = i if init_at is None else init_at
    row, _ = score_run(vo, seed, T_wc, stamps, poses, init_at)
    row["chunk"] = dict(vo.tracker.chunk_stats)
    return row, seconds


def same_keyframes(chunked, per_frame, what):
    """The chunk path makes the per-frame path's frames bit for bit (a
    consumed row is the per-frame frame; ``Tracker.process_chunk``), so a
    chunked run takes the same keyframes and loses the same frames."""
    for c, p in zip(chunked, per_frame):
        got = (c["keyframe_frame_ids"], c["frames_lost"], c["initialised_at_frame"])
        want = (p["keyframe_frame_ids"], p["frames_lost"], p["initialised_at_frame"])
        if got != want:
            raise AssertionError(f"sequence ({what}, seed {c['seed']}): chunked keyframes, frames lost, init {got} "
                                 f"!= per-frame {want}")


def cli_datasets(workdir):
    """``cli.make_synthetic_dataset`` writes the ``mono/3d`` scenes of seeds
    11-13 (24 frames at 240x320, ``.npy`` frames: the native prefetcher
    reads them) under ``workdir``; returns their directories."""
    import contextlib
    import io
    import shutil

    from ur_mvo_tpu_torch.cli import make_synthetic_dataset

    shutil.rmtree(workdir, ignore_errors=True)
    seqs = []
    for seed in ENGINE_SEEDS:
        seq = os.path.join(workdir, f"seq{seed}")
        with contextlib.redirect_stdout(io.StringIO()):
            make_synthetic_dataset.main(["--out", seq, "--frames", str(ENGINE_FRAMES), "--size", str(H), str(W),
                                         "--fx", str(FX), "--scene", "3d", "--seed", str(seed),
                                         "--image-format", "npy"])
        seqs.append(seq)
    return seqs


def cli_run_vo(seq, results, extra=()):
    """``cli.run_vo.main`` in-process on ``seq`` with shipped-matcher
    discovery and ``--gt``: (its returned summary, its stdout lines, the
    bytes of ``poses.txt`` and ``keyframes.txt``, the launches, seconds)."""
    import contextlib
    import io

    import torch

    from ur_mvo_tpu_torch.cli import run_vo
    from ur_mvo_tpu_torch.ops import cuda_ext

    out = io.StringIO()
    cuda_ext.LAUNCHES.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        summary = run_vo.main(["--images", seq, "--gt", os.path.join(seq, "gt.txt"), "--weights", SP_WEIGHTS,
                               "--results", results, "--stride", "1", *extra])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    files = {}
    for name in ("poses.txt", "keyframes.txt"):
        with open(os.path.join(results, name), "rb") as f:
            files[name] = f.read()
    return summary, out.getvalue().strip().splitlines(), files, dict(cuda_ext.LAUNCHES), seconds


def sequence_cli(smi, workdir):
    """The command line in-process: ``cli.make_synthetic_dataset`` writes
    the scenes of seeds 11-13 (``cli_datasets``), and ``cli.run_vo`` runs
    each with shipped-matcher discovery and ``--gt``, frame by frame and
    with ``--chunk 4``. Each run must have read its frames with the native
    prefetcher (as ``run_vo.main`` reports), print a parsable ATE line
    (finite, under 0.35) and launch the main-path kernels, and each chunked
    run must write its per-frame run's ``poses.txt`` and ``keyframes.txt``
    byte for byte and print the same ATE, pose and match counts (a consumed
    row is the per-frame frame bit for bit: ``Tracker.process_chunk``).
    Then ``cli.run_vo_multi`` runs the three lock-step with the production
    operating point as a config (a lane must take >= 3 keyframes). Returns
    the launches of each (``run_vo``'s of seed 11)."""
    import contextlib
    import hashlib
    import io

    import torch

    from ur_mvo_tpu_torch.cli import run_vo_multi
    from ur_mvo_tpu_torch.ops import cuda_ext

    seqs = cli_datasets(workdir)
    launches, rows, same = {}, {}, {}
    for seed, seq in zip(ENGINE_SEEDS, seqs):
        files = {}
        for name, extra in (("run_vo", []), ("run_vo --chunk 4", ["--chunk", "4"])):
            where = f"sequence (cli, {name}, seed {seed})"
            summary, lines, files[name], ran, seconds = cli_run_vo(
                seq, os.path.join(workdir, f"{name.replace(' ', '_').replace('-', '')}_{seed}"), extra)
            if seed == ENGINE_SEEDS[0]:
                launches[name] = ran
            if summary["reader"] != "native":
                raise AssertionError(f"{where}: the .npy frames were read by the {summary['reader']} reader")
            if not lines or not lines[-1].startswith("{"):
                raise AssertionError(f"{where}: no ATE line (too few poses to match the truth): {lines}")
            rec = json.loads(lines[-1])
            rows[f"{name} seed {seed}"] = {**rec, "reader": summary["reader"], "seconds": seconds,
                                           **{k: hashlib.sha256(v).hexdigest()[:16] for k, v in files[name].items()}}
            ate = rec["ate_rmse_m"]
            if not (ate == ate and 0.0 <= ate < 0.35):
                raise AssertionError(f"{where}: ATE {ate} (finite, < 0.35)")
            missing = [k for k in ENGINE_KERNELS if ran.get(k, 0) == 0]
            if missing:
                raise AssertionError(f"{where}: kernels never launched: {missing}")
        pf, ch = rows[f"run_vo seed {seed}"], rows[f"run_vo --chunk 4 seed {seed}"]
        same[seed] = {k: pf[k] == ch[k] for k in ("ate_rmse_m", "n_poses", "n_gt_matched")}
        same[seed].update({k: files["run_vo"][k] == files["run_vo --chunk 4"][k] for k in files["run_vo"]})
    # run_vo_multi discovers no matcher: the production operating point as a config
    cfg = os.path.join(workdir, "multi.yaml")
    with open(cfg, "w") as f:
        f.write(f"superpoint: {{weights_path: {SP_WEIGHTS}, keypoint_threshold: 1.0e-4, capacity: 1024, "
                f"max_keypoints: 1000}}\nsuperglue: {{weights_path: {SG_WEIGHTS}, nn_fallback_min_matches_init: 40}}\n"
                "initializer: {min_matches: 60, min_features_first: 100}\nbackend: {relocalization: true}\n")
    out = io.StringIO()
    cuda_ext.LAUNCHES.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run_vo_multi.main(["--images", *seqs, "--gt", *(os.path.join(q, "gt.txt") for q in seqs),
                           "--results", os.path.join(workdir, "multi"), "--config", cfg])
    torch.cuda.synchronize()
    launches["run_vo_multi"] = dict(cuda_ext.LAUNCHES)
    rows["run_vo_multi"] = {"lanes": [json.loads(line) for line in out.getvalue().strip().splitlines()],
                            "seconds": time.perf_counter() - t0}
    lanes = rows["run_vo_multi"]["lanes"]
    if len(lanes) != len(seqs) or max(r["n_keyframes"] for r in lanes) < MIN_KEYFRAMES:
        raise AssertionError(f"sequence (cli, run_vo_multi): no lane took {MIN_KEYFRAMES} keyframes: {lanes}")
    emit({"phase": "sequence", "part": "cli", "runs": rows, "chunked_equals_per_frame": same, "launches": launches,
          "card": smi})
    if not all(all(v.values()) for v in same.values()):
        raise AssertionError(f"sequence (cli): run_vo --chunk 4 differs from the per-frame run: {same}")
    return launches


def sequence_witness(smi):
    """``--sequence-witness``: whether the command line repeats itself on
    the card. The frames ``cli_datasets`` writes for seed 11, as the native
    and the Python readers return them, against the scene ``engine_scene``
    renders; then ``cli_run_vo`` frame by frame and with ``--chunk 4``,
    twice each, with the caller's deterministic algorithms on and off (the
    digests of ``poses.txt`` and ``keyframes.txt`` and the ATE line of each
    run: the CLI takes deterministic algorithms on CUDA itself, so the runs
    of each kind should share their bytes either way); and the engine's own
    per-frame run of the scene beside them."""
    import hashlib

    import numpy as np
    import torch

    from ur_mvo_tpu_torch.dataset import Dataset

    workdir = os.path.join(REPO, "build", "sequence_witness")
    seqs = cli_datasets(workdir)
    frames, T_wc = engine_scene(ENGINE_SEEDS[0])
    want = [f.image.get_image() for f in frames]
    images = {}
    for reader, prefetch in (("native", True), ("python", False)):
        ds = Dataset(seqs[0], prefetch=prefetch)
        got = [d.image for d in ds]
        images[reader] = {"reader": ds.reader, "equal": len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want))}
    runs = []
    for deterministic in (True, False):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        for rep in range(2):
            for name, extra in (("per_frame", []), ("chunk_4", ["--chunk", "4"])):
                summary, lines, files, _, seconds = cli_run_vo(
                    seqs[0], os.path.join(workdir, f"{name}_{deterministic}_{rep}"), extra)
                runs.append({"deterministic": deterministic, "rep": rep, "run": name, "reader": summary["reader"],
                             "line": lines[-1] if lines else None, "keyframes": files["keyframes.txt"].count(b"\n"),
                             **{k: hashlib.sha256(v).hexdigest()[:16] for k, v in files.items()}})
    torch.use_deterministic_algorithms(True, warn_only=True)
    vo = production_engine()
    row, _, _ = engine_run(vo, ENGINE_SEEDS[0], (frames, T_wc))
    vo.shutdown()
    torch.use_deterministic_algorithms(False)
    emit({"phase": "sequence_witness", "images": images, "runs": runs, "engine": row, "card": smi})


def sequence_phase(smi):
    """Phase 16, deterministic algorithms throughout: ``UR_MVO.process_sequence``
    with ``runtime.chunk_frames = 4`` on the ``mono/3d`` scenes of seeds 11-13
    beside their per-frame runs (phase 8's rows where it ran): the same
    keyframes and frames lost, phase 8's health, each seed's ATE and the
    means printed (not held to the 0.15 gate: the chunk path is opt-in),
    the chunk's rows (queued, consumed, weak, cut where the carried pose
    was read and differed), host syncs a frame and host ms a frame of both
    paths, and the five main-path kernels launched inside
    ``Tracker.process_chunk``; ``stereo/3d`` seed 11 chunked beside its
    per-frame run (the same keyframes, ``u_right`` kept at the keyframes
    chunk rows inserted); then the command line (``sequence_cli``).
    Returns the launches by path (``chunk``: the chunk path's own)."""
    import torch

    from ur_mvo_tpu_torch.ops import cuda_ext

    t_start = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    engines = []  # shut down (again: it is idempotent), and deterministic algorithms off, on a failure too
    try:
        scenes = {seed: engine_scene(seed) for seed in ENGINE_SEEDS}
        vo = production_engine()
        engines.append(vo)
        probe = ChunkLaunches(vo)

        # --- the per-frame references (phase 8's runs where it ran) -----------
        per_frame, syncs_pf, wall_pf = {}, collections.Counter(), 0.0
        for seed in ENGINE_SEEDS:
            per_frame[seed], ms, _ = counted_syncs(lambda s=seed: engine_run(vo, s, scenes[s]), syncs_pf)
            wall_pf += sum(ms) / 1e3
        if SINGLE_STREAM_ROWS and [r["keyframe_frame_ids"] for r in SINGLE_STREAM_ROWS] != [
                per_frame[s]["keyframe_frame_ids"] for s in ENGINE_SEEDS]:
            raise AssertionError("sequence: the per-frame runs here differ from phase 8's")

        # --- chunked, launches counted ----------------------------------------
        vo.config.runtime.chunk_frames = 4
        cuda_ext.LAUNCHES.clear()
        chunked, syncs_ch, wall_ch = {}, collections.Counter(), 0.0
        for seed in ENGINE_SEEDS:
            chunked[seed], seconds = counted_syncs(lambda s=seed: sequence_run(vo, s, scenes[s]), syncs_ch)
            wall_ch += seconds
        launches = dict(cuda_ext.LAUNCHES)
        n_frames = ENGINE_FRAMES * len(ENGINE_SEEDS)
        rows_c, rows_p = [chunked[s] for s in ENGINE_SEEDS], [per_frame[s] for s in ENGINE_SEEDS]
        stats = {k: sum(r["chunk"][k] for r in rows_c) for k in rows_c[0]["chunk"]}
        stats["discarded"] = stats["rows"] - stats["consumed"] - stats["weak"]

        def mean(rows):
            return statistics.mean(r["ate"] if r["ate"] is not None else float("nan") for r in rows)

        emit({"phase": "sequence", "part": "mono/3d", "chunk_frames": 4, "runs": rows_c,
              "ate": {"chunked": [r["ate"] for r in rows_c], "per_frame": [r["ate"] for r in rows_p],
                      "mean_chunked": mean(rows_c), "mean_per_frame": mean(rows_p)},
              "rows": stats,
              "syncs_a_frame": {"chunked": sum(syncs_ch.values()) / n_frames, "per_frame": sum(syncs_pf.values()) / n_frames},
              "sync_sites_a_frame": {"chunked": [[k, n / n_frames] for k, n in syncs_ch.most_common(10)],
                                     "per_frame": [[k, n / n_frames] for k, n in syncs_pf.most_common(10)]},
              # the sync counting is on in these runs
              "host_ms_a_frame": {"chunked": 1e3 * wall_ch / n_frames, "per_frame": 1e3 * wall_pf / n_frames},
              "launches": launches, "chunk_launches": probe.counts, "card": smi})
        same_keyframes(rows_c, rows_p, "mono/3d")
        for r in rows_c:
            where = f"sequence (mono/3d, seed {r['seed']})"
            if r["initialised_at_frame"] is None or r["keyframes"] < MIN_KEYFRAMES or r["frames_lost"] > MAX_FRAMES_LOST:
                raise AssertionError(f"{where}: init {r['initialised_at_frame']}, {r['keyframes']} keyframes, "
                                     f"{r['frames_lost']} frames lost")
        if stats["consumed"] == 0:
            raise AssertionError(f"sequence (mono/3d): the chunk path consumed no row: {stats}")
        missing = [k for k in ENGINE_KERNELS if probe.counts.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"sequence: kernels never launched inside process_chunk: {missing}")
        vo.shutdown()

        # --- stereo/3d seed 11 ------------------------------------------------
        seed = ENGINE_SEEDS[0]
        scene = metric_scene("stereo/3d", seed)
        stereo = metric_engine("stereo/3d")
        engines.append(stereo)
        ref, _, _ = engine_run(stereo, seed, scene)
        ref_uright = stereo_columns(stereo)
        stereo.config.runtime.chunk_frames = 4
        inserted = []
        process_chunk = stereo.tracker.process_chunk

        def noting(*a, **k):
            st = stereo.tracker.backend.store
            before = set(st.kf_frame_id[st.keyframe_slots()].tolist())
            out = process_chunk(*a, **k)
            inserted.extend(int(f) for f in st.kf_frame_id[st.keyframe_slots()] if int(f) not in before)
            return out

        stereo.tracker.process_chunk = noting
        row, _ = sequence_run(stereo, seed, scene)
        uright = stereo_columns(stereo)
        emit({"phase": "sequence", "part": "stereo/3d", "seed": seed, "chunked": row, "per_frame": ref,
              "inserted_by_chunk_rows": inserted, "u_right_rows": {"chunked": uright, "per_frame": ref_uright},
              "card": smi})
        same_keyframes([row], [ref], "stereo/3d")
        unseeded = [f for f in inserted if uright.get(f, 0) == 0 or uright[f] != ref_uright.get(f)]
        if not inserted or unseeded:
            raise AssertionError(f"sequence (stereo/3d): keyframes inserted by chunk rows {inserted}, "
                                 f"u_right rows {uright} against per-frame {ref_uright}")
        stereo.shutdown()

        cli = sequence_cli(smi, os.path.join(REPO, "build", "sequence"))
    finally:
        torch.use_deterministic_algorithms(False)
        for engine in engines:
            engine.shutdown()
    emit({"phase": "sequence", "seconds": time.perf_counter() - t_start})
    return {"chunk": probe.counts, "cli/run_vo": cli["run_vo"], "cli/run_vo_chunk": cli["run_vo --chunk 4"],
            "cli/run_vo_multi": cli["run_vo_multi"]}


# ---------------------------------------------------------------------------
# Phase 17: training and export
# ---------------------------------------------------------------------------

def train_rank(rank, world, backend, workdir):
    """``--train-rank R WORLD BACKEND DIR``: one rank of phase 17's
    data-parallel step on ``cuda:0`` under deterministic algorithms with
    TF32 off: the
    single-process step on the whole batch and ``make_dp_train_step`` on
    this rank's half (two model copies from the same weights); the loss,
    the descriptor head's gradients and parameters after the step and the
    DP step's stage-kernel launches, pickled to ``DIR/w{WORLD}_rank{R}.pkl``."""
    import pickle

    import torch

    from ur_mvo_tpu_torch.models import train_superpoint as train_sp
    from ur_mvo_tpu_torch.models.superpoint import SuperPoint
    from ur_mvo_tpu_torch.ops import cuda_ext
    from ur_mvo_tpu_torch.parallel import mesh as tmesh
    from ur_mvo_tpu_torch.parallel.train_step import make_dp_train_step

    t_start = time.perf_counter()
    # deterministic, and float32 convolutions (no TF32): the DP step and the
    # whole-batch step then differ only in the order of their sums
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.allow_tf32 = False
    dev = tmesh.init_distributed(backend, init_method=f"file://{workdir}/rendezvous_w{world}", world_size=world,
                                 rank=rank, device=MESH_DEVICE)
    mesh = tmesh.make_mesh(world)
    cuda_ext.extension()
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in inp["batch"].items()}
    out = {"rank": rank, "world": world}
    for name in ("single", "dp"):
        model = SuperPoint()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in inp["sp"].items()})
        model = model.to(dev)
        opt = train_sp.make_optimizer(model)
        step = train_sp.make_train_step(opt) if name == "single" else make_dp_train_step(opt, mesh)
        torch.cuda.synchronize()
        cuda_ext.LAUNCHES.clear()
        loss = step(model, batch)
        torch.cuda.synchronize()
        head = {n: p for n, p in model.named_parameters() if p.requires_grad}
        out[name] = {"loss": float(loss), "launches": dict(cuda_ext.LAUNCHES),
                     "params": {n: p.detach().cpu().numpy() for n, p in head.items()},
                     "grads": {n: p.grad.cpu().numpy() for n, p in head.items()},
                     "frozen_same": all(torch.equal(p.detach().cpu(), torch.from_numpy(inp["sp"][n]))
                                        for n, p in model.named_parameters() if not p.requires_grad)}
    out["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(workdir, f"w{world}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def start_train_ranks(workdir, sp_state):
    """Phase 17's data-parallel ranks, both worlds of ``MESH_WORLDS`` at
    once: the inputs (the shipped detector, a batch of 4 warped pairs of
    rendered 256x320 frames) pickled for them first."""
    import pickle

    import numpy as np
    import torch

    from ur_mvo_tpu_torch.models.train_superpoint import make_batch
    from ur_mvo_tpu_torch.utils.synthscene import render_sequence

    os.makedirs(workdir)
    imgs = render_sequence(4, TRAIN_CROP[0], TRAIN_CROP[1], FX, seed=31)[0]
    g = torch.Generator(device="cuda").manual_seed(17)
    batch = make_batch(g, torch.from_numpy(imgs).cuda().float() / 255.0)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump({"sp": {k: v.numpy() for k, v in sp_state.items()},
                     "batch": {k: v.cpu().numpy() for k, v in batch.items()}}, f)
    env = {**os.environ, "OMP_NUM_THREADS": "2", "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    env.pop("LOCAL_RANK", None)
    procs = []
    for world, backend, _ in MESH_WORLDS:
        for rank in range(world):
            log = open(os.path.join(workdir, f"w{world}_rank{rank}.log"), "w")
            procs.append((world, backend, rank, log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--train-rank", str(rank), str(world), backend, workdir],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)))
    return procs, np.asarray(batch["mask"].cpu())


def join_train_ranks(workdir, procs, mask, smi):
    """Wait for the ranks (``TRAIN_DEADLINE_S``) and hold them: world 1's DP
    step is its single step bit for bit (loss, gradients, parameters); at
    world 2 each rank's loss is the whole batch's within rtol 1e-5, its
    summed gradients within 1e-5 of the largest, its parameters within 1e-6
    (1e-3, lr, where the gradient is within 100x of Adam's epsilon), the two
    replicas bit for bit, every frozen parameter unchanged, 6 stage-kernel
    launches (two backbone calls) a DP step. Returns the DP steps' launches."""
    import pickle

    import numpy as np

    bad, deadline = [], time.monotonic() + TRAIN_DEADLINE_S
    try:
        for world, _, rank, _, p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                bad.append(f"world {world} rank {rank}: not done within {TRAIN_DEADLINE_S} s")
                break
    finally:
        for _, _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    outs, launches = {}, {}
    for world, backend, rank, _, p in procs:
        if p.returncode != 0:
            with open(os.path.join(workdir, f"w{world}_rank{rank}.log")) as f:
                text = f.read()
            bad.append(f"world {world} rank {rank} exited {p.returncode}")
            print(f"--- train rank w{world} r{rank} (exit {p.returncode}):\n{text[-3000:]}", file=sys.stderr, flush=True)
            continue
        with open(os.path.join(workdir, f"w{world}_rank{rank}.pkl"), "rb") as f:
            outs[world, rank] = o = pickle.load(f)
        ref, got = o["single"], o["dp"]
        scale = max(np.abs(g).max() for g in ref["grads"].values())
        if world == 1:
            same = ref["loss"] == got["loss"] and all(
                np.array_equal(ref[k][n], got[k][n]) for k in ("params", "grads") for n in ref["params"])
            faults = [] if same else ["the DP step at world 1 is not the single step bit for bit"]
        else:
            faults = []
            if abs(got["loss"] - ref["loss"]) > 1e-5 * abs(ref["loss"]):
                faults.append(f"loss {got['loss']} vs {ref['loss']}")
            for n, g in ref["grads"].items():
                if np.abs(got["grads"][n] - g).max() > 1e-5 * scale:
                    faults.append(f"{n} gradient off by {np.abs(got['grads'][n] - g).max() / scale} of the largest")
                limit = np.where(np.abs(g) > 1e-6, 1e-6, 1e-3)
                if not np.all(np.abs(got["params"][n] - ref["params"][n]) <= limit):
                    faults.append(f"{n} after the step: {np.abs(got['params'][n] - ref['params'][n]).max()}")
        dp_launch = got["launches"]
        if dp_launch.get("stage1_conv", 0) != 2 or dp_launch.get("stage_conv", 0) != 4:
            faults.append(f"DP step launches {dp_launch} (2 backbone calls: stage1_conv 2, stage_conv 4)")
        if not (got["frozen_same"] and ref["frozen_same"]):
            faults.append("a frozen parameter moved")
        launches[f"train/dp/w{world}" + (f"/r{rank}" if world > 1 else "")] = dp_launch
        emit({"phase": "training", "check": "dp_step", "world": world, "backend": backend, "rank": rank,
              "loss_dp": got["loss"], "loss_single_whole_batch": ref["loss"],
              "max_grad_diff_rel": float(max(np.abs(got["grads"][n] - g).max() for n, g in ref["grads"].items()) / scale),
              "max_param_diff": float(max(np.abs(got["params"][n] - ref["params"][n]).max() for n in ref["params"])),
              "launches": dp_launch, "seconds": o["seconds"], "faults": faults, "card": smi})
        bad += [f"world {world} rank {rank}: {f}" for f in faults]
    if all((2, r) in outs for r in range(2)):
        if not all(np.array_equal(outs[2, 0]["dp"]["params"][n], outs[2, 1]["dp"]["params"][n])
                   for n in outs[2, 0]["dp"]["params"]):
            bad.append("world 2: the replicas differ after the step")
        if mask[:2].sum() == mask[2:].sum():
            bad.append("world 2: the halves hold as many valid cells (the check cannot tell a mean of rank losses)")
    return launches, bad


def stage_op_check(sp, smi):
    """The stage op on the card in float32 at the training shapes, under
    deterministic algorithms with TF32 off: the three stages chained as the
    backbone chains them, forward within phase 3's float32 limit (1e-4 of
    the largest output) of the plain versions, 3 launches a backbone call
    (one a stage) and none in the backward. Its backward, stage by stage at
    the kernel path's own stage inputs and a fixed random projection of the
    stage's output, bit for bit the plain version's autograd (the op's
    backward IS the plain recompute). Chained, the gradients of a random
    projection of stage 3's output with respect to the input and the six
    weights and biases within 1e-2 (relative L2 norm) of the all-plain
    chain's: the kernel's forward differs from the plain one in its last
    bits, which moves a few 2x2 max-pool winners and ReLU gates in stages
    2-3, and each such flip reroutes one gradient entry whole (the largest
    entrywise difference is printed beside it); a backward that dropped or
    doubled a stage misses by O(1)."""
    import torch

    from ur_mvo_tpu_torch.models.superpoint import _STAGES
    from ur_mvo_tpu_torch.ops import cuda_conv, cuda_ext

    rows, bad = [], []
    g = torch.Generator(device="cuda").manual_seed(23)
    names = [n for pair in _STAGES for n in pair]
    params = [t.detach() for n in names for t in (getattr(sp, n).weight, getattr(sp, n).bias)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for B, Hh, Ww in (PRETRAIN_SHAPE, (FINETUNE_BATCH, *TRAIN_CROP)):
                x0 = torch.rand((B, Hh, Ww, 1), generator=g, device="cuda")
                runs = {}
                for plain in (False, True):
                    x = x0.clone().requires_grad_()
                    ps = [t.clone().requires_grad_() for t in params]
                    torch.cuda.synchronize()
                    cuda_ext.LAUNCHES.clear()
                    ys = [x]
                    for s in range(3):
                        ys.append(cuda_conv.stage_conv(ys[-1], *ps[4 * s:4 * s + 4], plain=plain))
                    proj = torch.randn(ys[-1].shape, generator=torch.Generator(device="cuda").manual_seed(5),
                                       device="cuda")
                    fwd = dict(cuda_ext.LAUNCHES)
                    grads = torch.autograd.grad((ys[-1] * proj).sum(), [x, *ps])
                    torch.cuda.synchronize()
                    runs[plain] = ([y.detach() for y in ys], grads, fwd, dict(cuda_ext.LAUNCHES))
                (ys, gk, fwd, total), (yps, gp, _, _) = runs[False], runs[True]
                err = (ys[-1] - yps[-1]).abs().max().item()
                tol = 1e-4 * yps[-1].abs().max().item()
                rel_l2 = max((torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item() for a, b in zip(gk, gp))
                max_rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(gk, gp))
                # each stage's backward at the kernel path's stage input
                exact = []
                for s in range(3):
                    outs = []
                    for plain in (False, True):
                        xs = ys[s].clone().requires_grad_()
                        ws = [t.clone().requires_grad_() for t in params[4 * s:4 * s + 4]]
                        y = cuda_conv.stage_conv(xs, *ws) if not plain else cuda_conv.stage_conv_plain(xs, *ws)
                        pr = torch.randn(y.shape, generator=torch.Generator(device="cuda").manual_seed(s), device="cuda")
                        outs.append(torch.autograd.grad((y * pr).sum(), [xs, *ws]))
                    exact.append(all(torch.equal(a, b) for a, b in zip(*outs)))
                row = {"shape": f"{B}x{Hh}x{Ww}", "max_abs_err": err, "tol": tol, "grad_rel_l2": rel_l2,
                       "grad_rel_l2_tol": 1e-2, "grad_max_abs_rel": max_rel, "stage_backward_bit_for_bit": exact,
                       "launches_forward": fwd, "launches_with_backward": total}
                rows.append(row)
                if not err <= tol:
                    bad.append(f"{row['shape']}: forward {err} > {tol}")
                if not rel_l2 <= 1e-2:
                    bad.append(f"{row['shape']}: chained gradients {rel_l2} (relative L2) of the all-plain ones (> 1e-2)")
                if not all(exact):
                    bad.append(f"{row['shape']}: a stage's backward is not the plain VJP bit for bit: {exact}")
                if fwd != {"stage1_conv": 1, "stage_conv": 2} or total != fwd:
                    bad.append(f"{row['shape']}: launches {fwd} forward, {total} with backward (1 + 2, none in backward)")
    finally:
        torch.use_deterministic_algorithms(False)
    emit({"phase": "training", "check": "stage_op", "rows": rows, "card": smi})
    return bad


def cell_scores_ratio(model, batch):
    """The JAX pretraining test's gate on ``batch``: (detector loss, mean
    score max of corner cells over background cells)."""
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.models.pretrain_superpoint import detector_loss

    img = torch.from_numpy(batch["image"]).cuda()
    lab = torch.from_numpy(batch["labels"]).cuda()
    with torch.no_grad():
        loss = detector_loss(model, img, lab).item()
        scores, _ = model(img[..., None])
    s = scores.cpu().numpy()
    B, Hh, Ww = s.shape
    cell = s.reshape(B, Hh // 8, 8, Ww // 8, 8).max(axis=(2, 4))
    return loss, float(cell[batch["labels"] != 64].mean() / cell[batch["labels"] == 64].mean())


def training_phase(smi):
    """Phase 17: training and export on the card (see the module docstring).
    Returns each path's launches."""
    import shutil

    import numpy as np
    import torch

    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.config import Configs
    from ur_mvo_tpu_torch.models import export as sp_export
    from ur_mvo_tpu_torch.models import pretrain_superpoint as pre
    from ur_mvo_tpu_torch.models import superglue as sg_mod
    from ur_mvo_tpu_torch.models import train_superglue as train_sg
    from ur_mvo_tpu_torch.models import train_superpoint as train_sp
    from ur_mvo_tpu_torch.models.superpoint import SuperPoint, load_torch_weights
    from ur_mvo_tpu_torch.ops import cuda_ba, cuda_ext, cuda_kernels, cuda_pose
    from ur_mvo_tpu_torch.runtime.extractor import NeuralExtractor
    from ur_mvo_tpu_torch.utils.synthscene import render_sequence

    t_phase = time.perf_counter()
    workdir = os.path.join(REPO, "build", "training")
    shutil.rmtree(workdir, ignore_errors=True)
    sp_state = load_torch_weights(SP_WEIGHTS)
    procs, dp_mask = start_train_ranks(workdir, sp_state)
    bad, launches, seconds = [], {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        cuda_ext.LAUNCHES.clear()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = dict(cuda_ext.LAUNCHES)
        return r

    # --- the stage op: forward, gradients, launches --------------------------
    sp32 = SuperPoint()
    sp32.load_state_dict(sp_state)
    bad += stage_op_check(sp32.cuda(), smi)

    # --- the grad-mode guard of the kernels without a gradient --------------
    dev = "cuda"
    q = torch.randn((2, 64, 4, 64), device=dev)
    valid = torch.ones((2, 64), dtype=torch.bool, device=dev)
    C = torch.randn((65, 65), device=dev)
    mu = torch.zeros(65, device=dev)
    A, Vp = torch.randn((64, 18), device=dev), torch.randn((64, 12), device=dev)
    ids = torch.zeros(64, dtype=torch.int64, device=dev)
    X = torch.randn((1, 32, 3), device=dev) + torch.tensor([0.0, 0.0, 5.0], device=dev)
    R0, t0 = torch.eye(3, device=dev)[None], torch.zeros((1, 3), device=dev)
    calls = {
        "attention": lambda r: cuda_kernels.attention(r(q), q, q, valid),
        "sinkhorn": lambda r: cuda_kernels.sinkhorn(r(C), mu, mu, 3),
        "log_optimal_transport_kernel": lambda r: cuda_kernels.log_optimal_transport_kernel(
            r(C[:64, :64]), valid[0], valid[0], torch.tensor(1.0, device=dev), 3),
        "pose_gn": lambda r: cuda_pose.pose_gn(R0, t0, r(X), X, valid[:1, :32], 200.0, 200.0, 32.0, 32.0, 0.0,
                                               5.99, 7.81, 1, 2, 1e-4),
        "point_reduce": lambda r: cuda_ba.point_reduce(r(A), Vp, ids, ids, 4, 2),
        "point_reduce_sorted": lambda r: cuda_ba.point_reduce_sorted(
            r(A), Vp, ids, ids, torch.tensor([0, 64, 64, 64, 64], device=dev), 2),
    }
    guard = {}
    for name, call in calls.items():
        try:
            call(lambda t: t.clone().requires_grad_())
            guard[name] = "returned"
        except RuntimeError as e:
            guard[name] = "raised" if "kernels=False" in str(e) and "plain=True" in str(e) else f"other: {e}"
        with torch.no_grad():
            call(lambda t: t.clone().requires_grad_())  # under no_grad the kernel runs
    emit({"phase": "training", "check": "grad_guard", "guard": guard, "card": smi})
    bad += [f"{k} under grad mode: {v}" for k, v in guard.items() if v != "raised"]

    # --- pretraining at full width -------------------------------------------
    Bp, Hp, Wp = PRETRAIN_SHAPE
    model = run("train/pretrain", lambda: pre.pretrain(torch.Generator().manual_seed(0), steps=PRETRAIN_STEPS,
                                                       batch=Bp, H=Hp, W=Wp, lr=PRETRAIN_LR, seed=0, log_every=0,
                                                       device="cuda"))
    held = pre.make_pretrain_batch(np.random.default_rng(123), Bp, Hp, Wp)
    trained, ratio = cell_scores_ratio(model, held)
    untrained, ratio0 = cell_scores_ratio(SuperPoint().init_random(torch.Generator().manual_seed(1)).cuda(), held)
    pl = launches["train/pretrain"]
    emit({"phase": "training", "check": "pretrain", "shape": list(PRETRAIN_SHAPE), "steps": PRETRAIN_STEPS,
          "lr": PRETRAIN_LR, "desc_objective": "nce", "s_per_step": seconds["train/pretrain"] / PRETRAIN_STEPS,
          "detector_loss_trained": trained, "detector_loss_untrained": untrained, "loss_ratio": trained / untrained,
          "corner_over_background": ratio, "corner_over_background_untrained": ratio0, "launches": pl, "card": smi})
    if not trained < 0.85 * untrained:
        bad.append(f"pretrain: trained detector loss {trained} not < 0.85 x untrained {untrained}")
    if not ratio >= 1.3:
        bad.append(f"pretrain: corner cells {ratio}x background (>= 1.3)")
    if pl.get("stage1_conv") != 3 * PRETRAIN_STEPS or pl.get("stage_conv") != 6 * PRETRAIN_STEPS:
        bad.append(f"pretrain launches {pl} (9 a step: 3 backbone calls)")

    # --- fine-tuning the descriptor head of the shipped detector --------------
    Bf = FINETUNE_BATCH
    frames = render_sequence(2 * Bf, TRAIN_CROP[0], TRAIN_CROP[1], FX, seed=32)[0]
    imgs = torch.from_numpy(frames).cuda().float() / 255.0
    eval_batch = train_sp.make_batch(torch.Generator(device="cuda").manual_seed(99), imgs[Bf:])
    ft = SuperPoint()
    ft.load_state_dict(sp_state)
    ft = ft.cuda()
    opt = train_sp.make_optimizer(ft)
    step = train_sp.make_train_step(opt)
    with torch.no_grad():
        before = train_sp.loss_fn(ft, eval_batch).item()
    gen = torch.Generator(device="cuda").manual_seed(1)
    losses = run("train/finetune", lambda: [float(step(ft, train_sp.make_batch(gen, imgs[:Bf])))
                                             for _ in range(FINETUNE_STEPS)])
    with torch.no_grad():
        after = train_sp.loss_fn(ft, eval_batch).item()
    changed = sorted({k.split(".")[0] for k, v in ft.state_dict().items() if not torch.equal(v.cpu(), sp_state[k])})
    fl = launches["train/finetune"]
    emit({"phase": "training", "check": "finetune", "batch": Bf, "crop": list(TRAIN_CROP), "steps": FINETUNE_STEPS,
          "s_per_step": seconds["train/finetune"] / FINETUNE_STEPS, "train_losses": losses,
          "held_out_loss_before": before, "held_out_loss_after": after, "layers_changed": changed,
          "launches": fl, "card": smi})
    if not (np.isfinite(losses).all() and after < before):
        bad.append(f"finetune: held-out loss {before} -> {after}, losses {losses}")
    if changed != ["convDa", "convDb"]:
        bad.append(f"finetune changed {changed} (only convDa, convDb)")
    if fl.get("stage1_conv") != 2 * FINETUNE_STEPS or fl.get("stage_conv") != 4 * FINETUNE_STEPS:
        bad.append(f"finetune launches {fl} (6 a step: 2 backbone calls)")

    # --- SuperGlue training at full width --------------------------------------
    sgc = SG_TRAIN
    held_sg = train_sg.make_batch_device(torch.Generator(device="cuda").manual_seed(999), sgc["batch"],
                                         sgc["capacity"], sgc["width"], sgc["height"])
    with torch.no_grad():
        sg_before = train_sg.batch_loss(train_sg.make_model(sgc["num_layers"], 0, None, torch.device("cuda")), *held_sg,
                                        sgc["width"], sgc["height"], 20, sgc["num_heads"]).item()
    chunks = []
    sg = run("train/superglue", lambda: train_sg.train_on_device(steps=SG_STEPS, chunk=SG_CHUNK, seed=0,
                                                                  log_fn=chunks.append, device="cuda", **sgc))
    with torch.no_grad():
        sg_after = train_sg.batch_loss(sg, *held_sg, sgc["width"], sgc["height"], 20, sgc["num_heads"]).item()
    emit({"phase": "training", "check": "superglue", **sgc, "steps": SG_STEPS, "chunk": SG_CHUNK,
          "s_per_step": seconds["train/superglue"] / SG_STEPS, "chunks": chunks, "held_out_loss_before": sg_before,
          "held_out_loss_after": sg_after, "launches": launches["train/superglue"], "card": smi})
    if not sg_after < sg_before:
        bad.append(f"superglue: held-out loss {sg_before} -> {sg_after}")
    if launches["train/superglue"]:
        bad.append(f"superglue training launched {launches['train/superglue']} (kernels=False: none)")

    # --- export of the frame step, reload, run ----------------------------------
    images = render_sequence(2, H, W, FX, seed=0)[0]
    a, b = (torch.from_numpy(im).cuda().float() / 255.0 for im in images)
    sg_state = sg_mod.load_weights(SG_WEIGHTS)
    meta = sg_mod.checkpoint_meta(SG_WEIGHTS)
    kw = dict(capacity=1024, max_keypoints=1000, threshold=1e-4, sinkhorn_iterations=20,
              match_threshold=sg_mod.checkpoint_threshold(SG_WEIGHTS) or 0.5, num_heads=meta[1] if meta else 4,
              device="cuda")
    path = os.path.join(workdir, "frame_step.pt2")
    exported = run("train/export_trace", lambda: sp_export.export_frame_step(path, sp_state, sg_state, H, W, **kw))
    nodes = sum(1 for n in exported.graph.nodes if "stage_conv" in str(n.target))
    loaded = run("train/export_load", lambda: sp_export.load_frame_step(path))
    with torch.no_grad():
        eager = sp_export.build_frame_step(sp_state, sg_state, H, W, **kw)(a, b)
        got = run("train/export", lambda: loaded(a, b))
    same = all(torch.equal(x, y) for x, y in zip(got, eager))
    cfg = front_end_config(Configs)
    cfg.runtime.compute_dtype = "float32"
    ext = NeuralExtractor(cfg, make_pinhole(W, H, FX, FX, W / 2, H / 2), device="cuda")
    b0, b1 = ext.extract(images[0]), ext.extract(images[1])
    m = ext.match(b0, b1, outlier_rejection=False)
    k0, k1, idx1 = (t.cpu().numpy() for t in got[:3])

    def kset(k):
        return set(map(tuple, k[np.any(k != 0, axis=1)]))

    overlap = [len(kset(k) & kpt_set(bank)) / max(len(kset(k)), len(kpt_set(bank)), 1)
               for k, bank in ((k0, b0), (k1, b1))]
    pairs = {(tuple(k0[i]), tuple(k1[idx1[i]])) for i in np.nonzero(idx1 >= 0)[0]}
    ref_pairs = pair_set(b0, b1, m)
    agree = len(pairs & ref_pairs) / max(len(pairs), len(ref_pairs), 1)
    el = launches["train/export"]
    emit({"phase": "training", "check": "export", "size": [H, W], "stage_conv_nodes": nodes,
          "outputs_equal_eager": same, "keypoint_overlap_extractor": overlap, "matches": len(pairs),
          "matches_extractor": len(ref_pairs), "match_agreement_extractor": agree, "launches": el,
          "trace_s": seconds["train/export_trace"], "load_s": seconds["train/export_load"],
          "run_ms": 1e3 * seconds["train/export"], "file_mb": os.path.getsize(path) / 2**20, "card": smi})
    if nodes != 6 or not same:
        bad.append(f"export: {nodes} stage_conv nodes (6), outputs equal to eager: {same}")
    if el.get("stage1_conv") != 2 or el.get("stage_conv") != 4:
        bad.append(f"export: the reloaded program launched {el} (stage kernel 6 times, 3 an image)")
    if min(overlap) < 0.95 or agree < 0.90 or len(pairs) < MIN_INLIERS:
        bad.append(f"export vs NeuralExtractor: overlap {overlap} (>= 0.95), agreement {agree} (>= 0.90), "
                   f"{len(pairs)} matches")

    dp_launches, dp_bad = join_train_ranks(workdir, procs, dp_mask, smi)
    launches.update(dp_launches)
    bad += dp_bad
    emit({"phase": "training", "check": "seconds", **seconds, "phase_s": time.perf_counter() - t_phase, "card": smi})
    if bad:
        raise AssertionError("training: " + "; ".join(bad))
    return {k: v for k, v in launches.items() if k in ("train/pretrain", "train/finetune", "train/superglue",
                                                       "train/export") or k.startswith("train/dp")}


# ---------------------------------------------------------------------------
# Phase 18: the accuracy matrix through its command line
# ---------------------------------------------------------------------------

def matrix_jax_means():
    """``ACCURACY.json``'s means (the JAX package's ``bench_accuracy.py``
    on the CPU) by cell and matcher, printed beside the card's; {} where the
    file is absent."""
    path = os.path.join(REPO, "ACCURACY.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        cells = json.load(f)["cells"]
    return {cell: {m: row.get("mean") for m, row in rows.items()} for cell, rows in cells.items()}


def collapsed_losses(bench_accuracy, counts):
    """Wraps ``cli.bench_accuracy.run_sequence`` so that each run appends
    to ``counts`` how many frames it lost while its reference keyframe
    held fewer than ``MULTI_SEQ_COLLAPSED`` triangulated points (a
    collapsed map: ROADMAP C11, C17). Returns the undo."""
    run_sequence = bench_accuracy.run_sequence

    def counted(vo, *a, **k):
        out, n = collapsed_counted(run_sequence, vo, *a, **k)
        counts.append(n)
        return out

    bench_accuracy.run_sequence = counted
    return lambda: setattr(bench_accuracy, "run_sequence", run_sequence)


def matrix_short(out_json, cell_list, matchers, seeds, frames, device):
    """(a): ``cli.bench_accuracy.main`` over some of the short matrix's
    cells into ``out_json``, launch counts reset before it (the CLI
    reports each cell's own). Returns the written document, each cell's
    launches and seconds, and each run's health with its frames lost to a
    collapsed map (``frames_lost_collapsed``, :func:`collapsed_losses`)."""
    from ur_mvo_tpu_torch.cli import bench_accuracy
    from ur_mvo_tpu_torch.ops import cuda_ext

    counts = []
    undo = collapsed_losses(bench_accuracy, counts)
    try:
        cuda_ext.LAUNCHES.clear()
        res = bench_accuracy.main(["--cells", cell_list, "--matchers", matchers, "--seeds", str(seeds),
                                   "--frames", str(frames), "--out", out_json, "--device", device])
    finally:
        undo()
    for run, n in zip(res["runs"], counts, strict=True):
        run["frames_lost_collapsed"] = n
    return res["doc"], {(c["cell"], c["matcher"]): c for c in res["cells"]}, res["runs"]


def matrix_table(doc, cells, runs, smi):
    """The production and ``nn`` rows of the cells run here, beside the JAX
    package's means, and the faults of the gates: the production
    matcher's of ``tests/test_accuracy_gates.py`` (no failed seed, mean
    under the bound), its runs' health (initialised, >= 3 keyframes, <= 6
    frames lost from a map it could track: the frames lost to a collapsed
    map, ``frames_lost_collapsed``, counted apart as ``multi_seq_health``
    counts them), and the kernels each column must and must not launch."""
    jax_means = matrix_jax_means()
    faults, ratios = [], {}
    for cell in dict.fromkeys(c for c, _ in cells):
        prod, bound = MATRIX_PRODUCTION[cell]
        for m in (prod, "nn"):
            row, info = doc["cells"][cell][m], cells[(cell, m)]
            mine = [r for r in runs if r["cell"] == cell and r["matcher"] == m]
            launches = info["launches"]
            emit({"phase": "matrix", "cell": cell, "matcher": m, "production": m == prod,
                  "max_frames_lost": None if m == "nn" else MAX_FRAMES_LOST, **row,
                  "host_ms_a_frame": statistics.median(r["host_ms_a_frame"] for r in mine),
                  "seconds": info["seconds"], "health": [{k: r[k] for k in (
                      "seed", "initialised_at_frame", "keyframes", "frames_lost", "frames_lost_collapsed", "lost_at",
                      "relocalizations", "poses_emitted")} for r in mine],
                  "jax_cpu_mean": jax_means.get(cell, {}).get(m), "launches": launches, "card": smi})
            if m == "nn":
                missing = [k for k in NN_KERNELS if not launches.get(k)]
                extra = [k for k in NN_ABSENT if launches.get(k)]
                if missing or extra:
                    faults.append(f"{cell} [nn]: kernels never launched {missing}, launched without SuperGlue {extra}")
                continue
            if row["failed"] or not row["mean"] < bound:
                faults.append(f"{cell} [{m}]: mean {row['mean']} (< {bound}), failed seeds {row['failed']}")
            for r in mine:
                lost = r["frames_lost"] - r["frames_lost_collapsed"]
                if r["initialised_at_frame"] is None or r["keyframes"] < MIN_KEYFRAMES or lost > MAX_FRAMES_LOST:
                    faults.append(f"{cell} [{m}] seed {r['seed']}: initialised at {r['initialised_at_frame']}, "
                                  f"{r['keyframes']} keyframes (>= {MIN_KEYFRAMES}), {lost} frames lost from a map "
                                  f"it could track (<= {MAX_FRAMES_LOST}; {r['frames_lost_collapsed']} more lost to "
                                  f"a collapsed map)")
            missing = [k for k in ENGINE_KERNELS if not launches.get(k)]
            if missing:
                faults.append(f"{cell} [{m}]: kernels of the path never launched: {missing}")
        nn_mean = doc["cells"][cell]["nn"]["mean"]
        ratios[cell] = doc["cells"][cell][prod]["mean"] / nn_mean if nn_mean else None
    emit({"phase": "matrix", "check": "winner", "production_mean_over_nn_mean": ratios,
          "jax_rule": MATRIX_WINNER_RATIO, "note": "a reading, not a gate: the 3-seed nn column carries C1's spread"})
    return faults


def v4stereo_run(smi, device="cuda"):
    """(d): ``tests/test_shipped_superglue_stereo.py``'s protocol with the
    shipped stereo checkpoint: the plane scene with a radtan-distorted right
    lens (``cli.make_synthetic_dataset.render_plane_sequence``), the right
    camera's rectify map built from that lens as the test builds it, the
    test's configuration with ``superglue_v4stereo.npz``, under
    deterministic algorithms, launch counts reset just before. Returns the
    run's launches and its faults: initialised, >= 3 keyframes, keyframe
    ATE (scale-corrected) finite and under the bound; every kernel
    launched."""
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.cli.make_synthetic_dataset import render_plane_sequence
    from ur_mvo_tpu_torch.components import Frame, Image
    from ur_mvo_tpu_torch.config import Configs, SensorSetup
    from ur_mvo_tpu_torch.engine import UR_MVO
    from ur_mvo_tpu_torch.ops import cuda_ext
    from ur_mvo_tpu_torch.utils.metrics import ate_rmse

    p = V4STEREO
    n = p["frames"]
    images, T_wc, images_r = render_plane_sequence(n, H, W, FX, seed=p["seed"], baseline=p["baseline"],
                                                   d_right=p["d_right"])
    cam = make_pinhole(W, H, FX, FX, W / 2, H / 2, bf=FX * p["baseline"])
    K_r = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    cam.undistort_map_right = cam._build_undistort_map(K_r, np.array(p["d_right"]), np.eye(3), 0)
    cfg = Configs()
    cfg.superpoint.weights_path = SP_WEIGHTS
    cfg.superpoint.capacity = 1024
    cfg.superpoint.max_keypoints = 1000
    cfg.superpoint.keypoint_threshold = 1e-4
    cfg.superglue.weights_path = V4STEREO_WEIGHTS
    cfg.superglue.image_width, cfg.superglue.image_height = W, H
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        vo = UR_MVO(cfg, SensorSetup.STEREO, camera=cam, device=device)
        cuda_ext.LAUNCHES.clear()
        t0, host_ms = time.perf_counter(), []
        for i in range(n):
            f = Frame(image=Image(images[i], i / FPS))
            f.right_image = Image(images_r[i], i / FPS)
            t1 = time.perf_counter()
            vo.process(f)
            host_ms.append(1e3 * (time.perf_counter() - t1))
        kts, kpos, _ = vo.keyframe_trajectory()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(cuda_ext.LAUNCHES)
        ate = None
        if len(kpos) >= 3:
            idx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, n - 1)
            ate = float(ate_rmse(np.asarray(kpos), T_wc[idx][:, :3, 3], align=True, correct_scale=True))
        row = {"initialised": bool(vo.tracker.initialized), "keyframes": len(kpos), "keyframe_ate": ate,
               "frames_lost": vo.tracker.frames_lost, "matcher": vo.config.superglue.matcher,
               "host_ms_a_frame_median": statistics.median(host_ms), "seconds": seconds, "launches": launches}
        vo.shutdown()
    finally:
        torch.use_deterministic_algorithms(was, warn_only=True)
    emit({"phase": "matrix", "path": "v4stereo", "frames": n, "baseline_m": p["baseline"], "d_right": p["d_right"],
          **row, "max_keyframe_ate": p["max_ate"], "card": smi})
    faults = []
    if not (row["initialised"] and row["keyframes"] >= MIN_KEYFRAMES and ate is not None and np.isfinite(ate)
            and ate < p["max_ate"]):
        faults.append(f"v4stereo: initialised {row['initialised']}, {row['keyframes']} keyframes (>= "
                      f"{MIN_KEYFRAMES}), keyframe ATE {ate} (< {p['max_ate']})")
    missing = [k for k in ENGINE_KERNELS if not launches.get(k)]
    if device == "cuda" and missing:
        faults.append(f"v4stereo: kernels of the path never launched: {missing}")
    return launches, faults


def matrix_part(part, smi, out_json=None, device="cuda", seeds=3, frames=ENGINE_FRAMES,
                long_frames=LONG_FRAMES, calls=MATRIX_CALLS):
    """One part of phase 18 (``MATRIX_PARTS``): ``"mono"`` and ``"metric"``
    (a) the short matrix's call of ``calls`` for their setups with its
    gates, ``"metric"`` also (d) the shipped stereo checkpoint; ``"long"``
    (c) ``--long --cells mono/long --matchers sg --seeds 1``. Returns what
    :func:`matrix_check` compares with phases 8-10: the 3d cells' runs, the
    long row, the launches by path, the faults and the seconds."""
    from ur_mvo_tpu_torch.cli import bench_accuracy
    from ur_mvo_tpu_torch.ops import cuda_ext

    t0 = time.perf_counter()
    out_json = out_json or os.path.join(MATRIX_DIR, f"{part}.json")
    out = {"part": part, "runs_3d": {}, "long": None, "launches_by_path": {}, "faults": []}
    if part == "long":
        cuda_ext.LAUNCHES.clear()
        res = bench_accuracy.main(["--long", "--cells", "mono/long", "--matchers", "sg", "--seeds", "1",
                                   "--frames", str(long_frames), "--out", out_json, "--device", device])
        (cell,) = res["cells"]
        out["long"] = res["doc"]["cells"]["mono/long"]["sg"]
        out["launches_by_path"]["matrix/mono/long/sg"] = cell["launches"]
        emit({"phase": "matrix", "path": "mono/long", "matcher": "sg", **out["long"], "health": res["runs"],
              "seconds": cell["seconds"], "launches": cell["launches"], "card": smi})
        missing = [k for k in ENGINE_KERNELS if not cell["launches"].get(k)]
        if device == "cuda" and missing:
            out["faults"].append(f"mono/long [sg]: kernels of the path never launched: {missing}")
    else:
        cell_list, matchers = calls[("mono", "metric").index(part)]
        doc, cells, runs = matrix_short(out_json, cell_list, matchers, seeds, frames, device)
        out["faults"] += matrix_table(doc, cells, runs, smi)
        out["launches_by_path"].update({f"matrix/{cell}/{m}": c["launches"] for (cell, m), c in cells.items()})
        out["runs_3d"] = {cell: doc["cells"][cell][MATRIX_PRODUCTION[cell][0]]["runs"] for cell, _ in cells
                          if cell.endswith("/3d")}
        if part == "metric":
            out["launches_by_path"]["matrix/v4stereo"], faults = v4stereo_run(smi, device)
            out["faults"] += faults
    out["seconds"] = time.perf_counter() - t0
    return out


def matrix_check(outs, smi):
    """(b) and (c) against the earlier phases where they ran: each seed's
    ATE of the 3d cells to the digit (the CLI's four) of phase 8's kernel
    run (``mono/3d`` sg) and phase 10's (``stereo/3d``, ``rgbd/3d``
    hybrid), and ``mono/long`` seed 11's online ATE and its ATE after
    ``global_optimize`` of phase 9's; then every fault of the parts.
    Returns the launches by path."""
    refs = {"mono/3d": {r["seed"]: r["ate"] for r in SINGLE_STREAM_ROWS}}
    refs.update(METRIC_ATES)
    faults, by_path = [], {}
    for out in outs:
        faults += out["faults"]
        by_path.update(out["launches_by_path"])
        for cell, got in out["runs_3d"].items():
            ref = refs.get(cell)
            want = [round(ref[s], 4) if ref.get(s) is not None else None for s in ENGINE_SEEDS] if ref else None
            emit({"phase": "matrix", "check": "3d cells against phases 8 and 10", "cell": cell, "cli": got,
                  "earlier_phase": want if want else "did not run: the CLI's readings alone"})
            if want and got != want:
                faults.append(f"{cell}: the CLI's runs {got} are not the earlier phase's {want}")
        if out["long"] is not None:
            ref = next((r for r in LONG_ROWS if r["seed"] == ENGINE_SEEDS[0]), None)
            want = None if ref is None else {
                "online": round(ref["online_ate"], 4) if ref["online_ate"] is not None else None,
                "pgo": round(ref["pgo_ate"], 4)}
            got = {"online": out["long"]["runs"][0], "pgo": (out["long"].get("pgo_runs") or [None])[0]}
            emit({"phase": "matrix", "check": "mono/long seed 11 against phase 9", "cli": got,
                  "phase_9": want if want else "did not run: the CLI's readings alone"})
            if want and got != want:
                faults.append(f"mono/long seed 11: the CLI's {got} is not phase 9's {want}")
    emit({"phase": "matrix", "check": "seconds", "parts": {o["part"]: o["seconds"] for o in outs},
          "processes": {o["part"]: o.get("process_s") for o in outs}, "budget": MATRIX_BUDGET_S, "card": smi})
    if faults:
        raise AssertionError("matrix: " + "; ".join(faults))
    return by_path


def matrix_side(workdir, part):
    """``--matrix-side DIR PART``: one part of phase 18 in a process of its
    own, its result (or the error) pickled to ``DIR/side.pkl``. The parent
    built the extension; this process loads it."""
    import pickle
    import traceback

    from ur_mvo_tpu_torch.ops import cuda_ext

    t0 = time.perf_counter()
    cuda_ext.extension()
    try:
        out = matrix_part(part, nvidia_smi_line())
    except Exception:  # the parent reports it as the phase's failure
        out = {"part": part, "error": traceback.format_exc()}
    out["process_s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, "side.pkl"), "wb") as f:
        pickle.dump(out, f)


def stereo_columns(vo):
    """Per keyframe (by frame id), the rows of its keypoints that hold a
    gated right x (``u_right > 0``): the stereo seeds."""
    st = vo.tracker.backend.store
    return {int(st.kf_frame_id[s]): int((st.kf_kpts[s, :, 2] > 0).sum()) for s in st.keyframe_slots()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 2
    if "--mesh-rank" in sys.argv:
        i = sys.argv.index("--mesh-rank")
        rank, world, backend, workdir = sys.argv[i + 1 : i + 5]
        mesh_rank(int(rank), int(world), backend, workdir)
        return 0
    if "--train-rank" in sys.argv:
        i = sys.argv.index("--train-rank")
        rank, world, backend, workdir = sys.argv[i + 1 : i + 5]
        train_rank(int(rank), int(world), backend, workdir)
        return 0
    if "--metric-side" in sys.argv:
        metric_side(sys.argv[sys.argv.index("--metric-side") + 1])
        return 0
    if "--matrix-side" in sys.argv:
        i = sys.argv.index("--matrix-side")
        matrix_side(sys.argv[i + 1], sys.argv[i + 2])
        return 0
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
        def names(flag):
            return sys.argv[sys.argv.index(flag) + 1].split(",") if flag in sys.argv else []

        engine_sweep([int(x) for x in names("--engine-seeds")],
                     repeats=int(sys.argv[sys.argv.index("--repeats") + 1]) if "--repeats" in sys.argv else 2,
                     scene=sys.argv[sys.argv.index("--scene") + 1] if "--scene" in sys.argv else "3d",
                     swap=names("--swap"), only=names("--only"), audit="--audit" in sys.argv)
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
    if "--metric-seeds" in sys.argv:
        i = sys.argv.index("--metric-seeds")
        try:
            metric_seeds(sys.argv[i + 1], [int(x) for x in sys.argv[i + 2].split(",")],
                         kernels="--plain" not in sys.argv, float32_point_side="--float32-point-side" in sys.argv)
        except AssertionError as e:
            emit({"phase": "metric", "failed": str(e)})
            print(smi, flush=True)
            return 1
        print(smi, flush=True)
        return 0
    if "--only-extras" in sys.argv:
        try:
            extras_phase(smi)
        except AssertionError as e:
            emit({"phase": "extras", "failed": str(e)})
            print(smi, flush=True)
            return 1
        print(smi, flush=True)
        return 0
    if "--multi-seq-witness" in sys.argv:
        multi_seq_witness(smi)
        print(smi, flush=True)
        return 0
    if "--only-multi-seq" in sys.argv:
        try:
            multi_seq_phase(smi)
        except AssertionError as e:
            emit({"phase": "multi_seq", "failed": str(e)})
            print(smi, flush=True)
            return 1
        print(smi, flush=True)
        return 0
    if "--only-mesh" in sys.argv:
        try:
            mesh_phase(smi)
        except AssertionError as e:
            emit({"phase": "mesh", "failed": str(e)})
            print(smi, flush=True)
            return 1
        print(smi, flush=True)
        return 0
    if "--sequence-witness" in sys.argv:
        sequence_witness(smi)
        print(smi, flush=True)
        return 0
    if "--only-sequence" in sys.argv:
        try:
            sequence_phase(smi)
        except AssertionError as e:
            emit({"phase": "sequence", "failed": str(e)})
            print(smi, flush=True)
            return 1
        print(smi, flush=True)
        return 0
    if "--only-training" in sys.argv:
        try:
            training_phase(smi)
        except AssertionError as e:
            emit({"phase": "training", "failed": str(e)})
            print(smi, flush=True)
            return 1
        print(smi, flush=True)
        return 0
    if "--only-matrix" in sys.argv:
        import shutil

        shutil.rmtree(MATRIX_DIR, ignore_errors=True)
        os.makedirs(MATRIX_DIR)
        try:
            matrix_check([matrix_part(part, smi) for part in MATRIX_PARTS], smi)
        except AssertionError as e:
            emit({"phase": "matrix", "failed": str(e)})
            print(smi, flush=True)
            return 1
        print(smi, flush=True)
        return 0
    if "--deterministic-witness" in sys.argv:
        deterministic_witness(smi)
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
    metric = start_side("--metric-side", "metric", METRIC_DEADLINE_S)
    matrix = start_matrix_sides()
    try:
        long_launches, long_shape = timed("long", long_phase, smi, on_failure=({}, BA_KERNEL_SHAPES[0]))
        extras_launches = timed("extras", extras_phase, smi, on_failure={})
    finally:
        # "metric" and "matrix" are the waits for their processes, which ran
        # beside these two
        metric_launches = timed("metric", join_metric_side, metric, on_failure={})
        matrix_launches = timed("matrix", join_matrix_sides, matrix, smi, on_failure={})
    multi_seq_launches = timed("multi_seq", multi_seq_phase, smi, on_failure={})
    # before phase 15, which compares with its solution
    point_reduce = timed("global_ba", global_ba_phase, smi, on_failure={}).get("point_reduce", 0)
    mesh_launches = timed("mesh", mesh_phase, smi, on_failure={})
    sequence_launches = timed("sequence", sequence_phase, smi, on_failure={})
    training_launches = timed("training", training_phase, smi, on_failure={})
    by_path = {"mono/3d": dict(launches), "mono/long": long_launches, **metric_launches, **extras_launches,
               **multi_seq_launches, **mesh_launches, **sequence_launches, **training_launches, **matrix_launches}
    rows.update(timed("ba_kernels", ba_kernels_phase, smi, (long_shape, BA_KERNEL_SHAPES[1]), on_failure={}))
    # the sorted kernel's launches are those of global_optimize's full BA;
    # the unsorted kernel runs only where "pallas" is asked for
    launches["point_reduce_sorted"] = long_launches.get("point_reduce_sorted", 0)
    launches["point_reduce"] = point_reduce
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
            "launches_by_path": {path: counts.get(name, 0) for path, counts in by_path.items()},
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
