#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (flame_ros_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one line:

1. environment: the card (nvidia-smi name and power limit), torch and
   CUDA versions, TF32 off;
2. kernel build: csrc/raster.cu compiled from this checkout with nvcc;
3. kernels vs plain versions at VGA with T = 4096 triangle slots
   (Delaunay of 2048 seeded random points, and of 1300 of them for the
   engine's density): the v4, v2 and v3 raster kernels must equal their
   plain PyTorch versions bit for bit on an unsorted, a y-sorted, an
   engine-density, a long-triangle, a forced-fallback (budgets so small
   that the TPU v3 falls back to v2; the port's v3, which has none, must
   give v2's ids there), an empty, a sliver and a multi-chunk mesh, each
   wrapper call making one launch of its own kernel and none of another
   (wrapper counts and device work counters); whether the TPU v3's
   budgets would hold; CUDA-event medians of the kernel alone (one launch
   between two events, and back to back on the card), of the wrapper and
   of the plain version, beside the kernel's bound;
4. the main path: `run_offline` at VGA with the default FlameParams over
   60 frames rendered on the card — health on every frame, the v4 kernel
   launched and doing the work on every frame and v2 on none, the id
   buffer of six frames recomputed from the engine's own state by the
   plain v4 version (equal) and by the plain formulation `ops/raster.py::
   rasterize_tri_ids` (equal but on the few pixels that v4's evaluation
   order and its own split at VGA), whether the TPU v3's budgets would
   hold there, every frame equal bit for bit to the CPU's rendering of
   it (image, depth and pose; phases 5-13 read the same frames),
   ms/frame and accuracy; then the v4 and v2 kernels timed on those six
   frames' inputs (kernel only and wrapper, CUDA-event medians), each
   equal to its plain version there; then, after the timed frames, one
   more frame through the same engine with `debug.profile_stages` on,
   whose hook re-times every stage (the 13 stage timings printed);
5. the windowed streaming path at VGA, room/strafe: (a)
   `run_offline_windowed` with windows of 6 and synchronous
   triangulation over the same 60 frames, held against the JAX package's
   CPU run of that sequence; (b) 120 host frames (more than two wraps of
   the 8-keyframe ring) streamed as windows of 6 with prefetch depth 2
   and deferred triangulation: ms/frame, frames/s, coverage per window,
   topology install counters, accuracy and the raster work split; the
   per-frame path's accuracy over the same frames; and prefetched
   windows bit for bit equal to plain `update_window` calls;
6. small-input agreement: the same 96x128 frames through the card path
   (CUDA kernels) and the CPU path (plain versions);
7. the live frontend at VGA with the default FlameParams, over phase 4's
   60 frames: (a) a FlameNodelet fed by a producer thread while its
   consumer thread runs — every frame processed, none dropped, health
   READY at both ends, per-frame accuracy equal to phase 4's, v4 doing
   the raster work on every frame, process_frame_ms and latency_ms
   p50/p95 (of the burst, and of frames pushed at 30 frames/s); (b) at
   frame 30, poseframe_callback with the live poseframes' poses moved by
   a fixed SE3 and then with one id dropped, held against a numpy
   recomputation, and save_checkpoint/load_checkpoint: the resumed and
   the uninterrupted engine run to frame 60 and must agree bit for bit;
   (c) FlameServer on 127.0.0.1: one client streams 30 uint8 frames and
   gets every stats message and the idepth map, a second polls meshes,
   and stop() closes both; (d) epipolar_mode="patch" and the truth
   harness (--pass-in-truth), each held against the JAX package's CPU
   run of the sequence; (e) the TUM and ASL loaders and CLI routes over
   the same frames written as a TUM and an ASL tree;
8. tracking mode at VGA with the default FlameParams (no poses in: the
   direct tracker and the keyframe pose graph estimate them; GT depth on
   frame 0 only, plus the stats' confusion matrix): (a) phase 4's 60
   frames through `run_offline_tracking` on the card — every frame
   tracked, none failed, ATE, rmse, recall and coverage held against the
   JAX package's CPU run of the sequence, v4 doing the raster work on
   every frame; (b) the same frames with frames 24-30 replaced by white
   flashes (`with_occlusion`) — every occluded frame fails and stays out
   of the trajectory, the failure and relocalization counts against the
   JAX run's and within the JAX test's bounds, the engine healthy. Each
   run prints tracking ms/frame p50/p95 beside phase 4's, and
   `track_frame` / `ring_relocalize` ms per call (CUDA events) and device
   launches per call (profiler), each checked to make no host sync;
9. tracking mode with windowed bundle adjustment (`ba_refine=True`) on
   phase 8 (a)'s frames: every frame tracked, v4 doing the raster work
   on every frame, and the run held to the JAX package's CPU runs of the
   sequence with `--ba-refine`: frame by frame through frame 27 (poses
   within 1e-4 of the run on the sequence itself, the first three
   solves' costs within 1e-3 relative), and rmse, recall, coverage, ATE
   and the number of solves each within the spread of the JAX runs on
   the sequence and on fifteen copies of it moved by one float32 step
   (the closed loop parts from frame 28), in phase 8's bands about that
   spread; the last solve on the card against the same solve on the
   CPU;
   `hybrid_bundle_adjust` ms per call (p50, max), its device launches and
   card-busy ms per call, `bundle_adjust_window`'s alone and checked to
   make no host sync, `ba_refine`'s share of its poseframe's ms, and
   tracking+BA ms/frame p50/p95 beside phase 8's and phase 4's;
10. many streams on one card (`parallel/multi_stream.py`), phase 4's 60
   frames, stream k fed frame max(i - k, 0), every op under
   torch.func.vmap checked to have a batching rule: (a) S = 4 with
   synchronous triangulation — one launch of the batched v4 kernel per
   update covering the 4 streams (wrapper and device counters) and no
   launch of v4, v2 or v3, its id buffers on the runner's own inputs on
   seven frames (three poseframes) equal to the plain version bit for bit
   (and to the plain formulation up to order_split), no host sync in
   `batched_full_step`, each stream's mean rmse, recall and final
   coverage within 1 % / 0.01 / 0.01 of a single engine fed its frames,
   and the state leaves equal to that engine's at frames 6 and 60
   printed; (c) a checkpoint at frame 30 loaded into a fresh runner,
   both run to frame 60 and equal bit for bit, get_meshes and
   get_idepth_maps; (b) S = 1, 2, 4, 8 with deferred triangulation:
   ms per update p50/p95 (to the stats read), aggregate frames/s,
   launches and card-busy ms per update (profiler), host ms of a
   poseframe round's Delaunay builds, rounds dropped, beside phase 4's
   ms/frame, the launches per update at S = 8 within 1.25x of S = 1;
   and the batched kernel timed at S = 1, 4 and 8 beside S times the
   single-image bound;
11. viz on phase 4's final engine: the six debug products (the idepthmap
   product colored exactly on the finite pixels of the idepth map), host
   ms per product, the final mesh as PLY and as the HTML viewer read back
   (vertex and face counts), and a FlameServer on the card, fed 10 frames
   by the feeder `scripts/stream_synthetic_torch.py` (its `main`),
   streaming to a LiveMeshViewer whose mesh JSON grows;
12. many devices on the one card, each layout naming it several times,
   13 frames (three installs) of phase 4's sequence, stream k fed frame
   max(i - k, 0): (a) stream groups, S = 4 on [cuda:0] * 2 and S = 8 on
   [cuda:0] * 4 — every state leaf equal to the plain runner's bit for
   bit, one batched v4 launch per group and update (the runner's
   per-group counts, the wrapper's and the device work counter), no
   host sync in a group's step; (b) the spatial NLTGV2 partition, S = 2
   on [[cuda:0] * 2] and [[cuda:0] * 4], against the plain runner with
   the CPU test's bounds (maps 1e-4, vtx_x and edge_q 1e-5, graph
   membership equal, stats 1e-3 relative), no host sync in
   `batched_full_step_spatial`, the sweep's CUDA-event ms beside the
   plain sweep's; a checkpoint written before frame 8 loaded into a
   fresh spatial runner (the installed edges equal to a fresh host
   Delaunay of the restored vertices, the install watermark equal to
   `_max_frame_id`, as the JAX package re-triangulates at load) and run
   on to frame 13, no host sync in `batched_full_step_spatial` on the
   load's partitions; (c) `hybrid_bundle_adjust_sharded` over [cuda:0] * 2
   and * 4 at 16384 point lanes on phase 9's final window (its selected
   points, the rest padding) within 1e-5 of the unsharded solve, no
   host sync in `bundle_adjust_window_sharded`, ms / launches / busy ms
   per call beside the unsharded one, and the nodelet with
   ba_sharded=True equal to phase 9's frame by frame over 20 frames;
   (d) `parallel/dist_e2e.py` as two gloo processes sharing the card:
   each rank's payload equal to the single-process run's, a --spatial
   run, and a run killed after its frame-7 shards restarted from them to
   the uninterrupted payload; a failed rank fails the phase. Each layout
   prints ms per update p50/p95, aggregate frames/s, launches and busy
   ms beside the card's name and power limit;
13. the last modules: (a) the feature-axis layout (`make_mesh(
   stream_axis=1)`, `parallel/feat_shard.py`), S = 2 with each stream's
   lanes over F = 2 and 4 blocks on cuda:0 named F times, 13 frames of
   phase 12's streams: every state leaf equal to the plain runner's bit
   for bit, the stats within 1e-5 relative (split cost sums), one
   batched v4 launch per update, no host sync in a feat step, ms per
   update, launches and busy ms beside the plain runner's; (b)
   `parallel/dist_smoke.py` as two gloo ranks sharing the card, the
   feature axis across them: both print DIST_OK with the coverage of the
   single-process plain step exactly; (c) phase 4's 60 frames with
   compute_dtype="bfloat16" and (d) with nltgv2_adjoint="matmul", each
   through phase 4's checks (health, v4 on every frame and checked
   against its plain version) and within JAX_BAND of JAX_BF16_VGA /
   JAX_MATMUL_VGA, ms/frame beside a rerun of phase 4 in the same
   place (its digits equal to phase 4's); the epipolar update timed
   with f32 and bf16 gathers, and the NLTGV2 sweep with the gather and
   the matmul adjoint, on the final state (CUDA-event medians with the
   host's issue, launches and card-busy ms by the profiler), the matmul
   sweep checked to make no host sync;
14. the external-pose acceptance protocol of tests/test_acceptance.py
   and tests/test_acceptance_stress.py (ACCEPT_RUNS: default, rotation,
   low texture, both, exposure A and B, mav, primitives, and the TUM
   and ASL pipelines; VGA, 200 frames, default FlameParams) through the
   port's CLI `offline_runner.main`, rendered on the card, every frame
   equal bit for bit to the CPU's (which the JAX runs read; the CPU's
   rendered from phase 1 on in a process of its own, CpuFrames, and
   compared by digests): 200 frames, none failed, every
   frame healthy, v4 launched on every frame and v2 and v3 never
   (wrapper counts and device work counters), the id buffer of frame 97
   and of poseframe 150 (after the third ring wrap, before its install)
   equal to the plain v4 version's recomputation (and to the plain
   formulation up to order_split); each run held to the JAX package's
   CPU run of the same frames (JAX_ACCEPT_VGA200): rmse, recall and
   coverage within JAX_BAND, every gate of the JAX test that the JAX run
   passes passed (the ones it fails printed, the run held to JAX's
   there), exposure B beating A as in JAX; ms/frame p50/p95 per run
   beside the card's name and power limit.

Any failure exits non-zero. The line before the last is the card's
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`; before
it, one JSON line of per-kernel numbers. The last line is the contract
line {"ok": true, "device": {...}}. Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero and
prints no result.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "run_out", "chip_smoke")
# The least time of a raster kernel: the larger of its bytes (output and
# slab, each once) over the HBM3 rate and its inside tests over the f32
# instruction rate. The kernels are built with -fmad=false (the id buffer
# must match the plain version bit for bit), so a multiply and an add
# issue as two instructions: the rate is 132 SMs x 128 f32 lanes x the
# 1.98 GHz boost clock that the data sheet's 67 TFLOP/s (an FMA counted
# as two flops) implies, 33.5e12 instructions/s. H100 SXM data sheet.
F32_INSTR_RATE = 132 * 128 * 1.98e9
PEAK_BYTES = 3.35e12
# f32 instructions per inside test, the per-row term hoisted: v4 x*a + d
# per edge (2 x 3); v2 and v3 (x*a + y*b) + c with y*b hoisted (3 x 3).
INSTR_PER_TEST = {"v4": 6, "v2": 9, "v3": 9}
# The JAX package on the CPU over the phase-5 (a) sequence:
#   JAX_PLATFORMS=cpu python -m flame_ros_tpu.frontends.offline_runner \
#       --dataset synthetic --frames 60 --resolution vga --window 6
# printed rmse 0.04661, recall 0.7433, coverage 0.7429 (PERF.md).
JAX_WINDOWED_VGA = {"idepth_rmse": 0.04661, "recall": 0.7433,
                    "coverage": 0.7429}
# The JAX package on the CPU over the phase-4 sequence, per frame, with
# exact per-candidate patch warps in the epipolar search:
#   JAX_PLATFORMS=cpu python -m flame_ros_tpu.frontends.offline_runner \
#       --dataset synthetic --frames 60 --resolution vga \
#       --config cfg/epipolar_patch.yaml
# and with the truth harness (same command, --pass-in-truth instead of
# --config). Phase 7 (d) holds the port to each within JAX_BAND: rmse
# relative, recall and coverage absolute.
JAX_PATCH_VGA = {"idepth_rmse": 0.04369, "recall": 0.7381,
                 "coverage": 0.8533}
JAX_TRUTH_VGA = {"idepth_rmse": 0.02795, "recall": 0.7657,
                 "coverage": 0.8405}
JAX_BAND = {"idepth_rmse": 0.05, "recall": 0.02, "coverage": 0.02}
# The JAX package on the CPU over the phase-4 sequence in tracking mode,
# and with frames 24-30 occluded:
#   JAX_PLATFORMS=cpu python -m flame_ros_tpu.frontends.offline_runner \
#       --dataset synthetic --frames 60 --resolution vga \
#       --pose-source tracking [--occlude 24:30]
# Phase 8 holds the port to each: rmse, recall and coverage within
# JAX_BAND, ATE within max(25 % relative, 1e-3 m).
JAX_TRACK_VGA = {"frames": 60, "idepth_rmse": 0.04446, "recall": 0.7705,
                 "coverage": 0.8796, "ate_rmse": 0.00105,
                 "ate_rmse_sim3": 0.00104, "rpe_trans_rmse": 0.00119,
                 "rpe_rot_rmse_deg": 0.0239, "track_failed_frames": 0,
                 "relocalizations": 0}
JAX_OCCLUDE_VGA = {"frames": 53, "idepth_rmse": 0.05073, "recall": 0.7564,
                   "coverage": 0.8734, "ate_rmse": 0.00188,
                   "ate_rmse_sim3": 0.00153, "rpe_trans_rmse": 0.00128,
                   "rpe_rot_rmse_deg": 0.0261, "track_failed_frames": 7,
                   "relocalizations": 0}
# The same with windowed bundle adjustment on every poseframe, on the
# port's rendered frames:
#   JAX_PLATFORMS=cpu python scripts/jax_tracking_reference.py --ba-refine
# (97 s on the CPU). Its first three solves' costs are JAX_TRACK_BA_COSTS
# and its poses through frame 27 JAX_TRACK_BA_POSES ([img_id, qw, qx, qy,
# qz, tx, ty, tz]). The same run on the same frames with a random half of
# their pixels moved one float32 step up, for K = 1 .. 15:
#   JAX_PLATFORMS=cpu XLA_FLAGS="--xla_cpu_multi_thread_eigen=false \
#       intra_op_parallelism_threads=1" python \
#       scripts/jax_tracking_reference.py --ba-refine --poses --perturb K
# (99-156 s each on the CPU, 8 at a time; K = 0 gives this run to every
# digit). A step of one float32 ulp is the size of the rounding by which
# two implementations of the same arithmetic differ. Every run stays
# within 5.2e-5 of this one through frame 27, and from frame 28 the
# closed loop takes other branches. JAX_TRACK_BA_SPREAD is the smallest
# and largest value of each metric over the sixteen runs (K = 0 .. 15).
# Phase 9 holds the port to this run frame by frame through frame 27
# (poses within TRACK_BA_POSE_TOL, costs within TRACK_BA_COST_TOL), and
# each of its metrics to phase 8's bands about that spread (no further
# from its nearer end than the band, ATE's band 25 % of that end).
JAX_TRACK_BA_VGA = {"frames": 60, "idepth_rmse": 0.05408, "recall": 0.7722,
                    "coverage": 0.8672, "ate_rmse": 0.02991,
                    "ate_rmse_sim3": 0.02649, "rpe_trans_rmse": 0.00788,
                    "rpe_rot_rmse_deg": 0.1603, "track_failed_frames": 0,
                    "relocalizations": 0, "ba_solves": 7}
JAX_TRACK_BA_COSTS = (2.663280963897705, 2.0654830932617188,
                      2.253582715988159)
JAX_TRACK_BA_SPREAD = {
    "idepth_rmse": (0.05082291147361199, 0.06092065821091334),
    "recall": (0.7634243164062499, 0.7729645182291667),
    "coverage": (0.8438020944595337, 0.8884961009025574),
    "ate_rmse": (0.01843284784372517, 0.05315985392607937),
    "ba_solves": (7, 8),
}
JAX_TRACK_BA_POSES = [
    [0, 1, 0, 0, 0, 0, 0, 0],
    [1, 0.999996364, -1.90984374e-05, 0.00261830608, -3.71541464e-05, 0.0640292913, 0.00085615163, 0.00210590009],
    [2, 0.999985993, 1.91127074e-05, 0.005250772, -9.58724468e-06, 0.127013355, 0.00411693519, 0.00418805238],
    [3, 0.999968767, -5.06469914e-05, 0.00786049198, -3.5524241e-05, 0.188485488, 0.00867857691, 0.00582007505],
    [4, 0.999945939, -5.64438196e-05, 0.0103341844, -3.72372015e-05, 0.248001173, 0.0156672988, 0.00722049968],
    [5, 0.999918401, -2.78708267e-05, 0.0126432041, -3.0192783e-05, 0.305036128, 0.0246907584, 0.00853112713],
    [6, 0.999884784, -6.47533525e-05, 0.014916949, -4.06725412e-05, 0.357975006, 0.0350302644, 0.0094620334],
    [7, 0.999846637, -3.03140459e-05, 0.0169502106, -4.20902834e-05, 0.407271266, 0.0474046171, 0.0103926901],
    [8, 0.999811471, -9.30727547e-05, 0.0189176984, -5.1560768e-05, 0.451116562, 0.0606819093, 0.0113446247],
    [9, 0.999783397, 0.000137896204, 0.0203618053, 4.80758536e-06, 0.491716802, 0.0773770437, 0.0131261507],
    [10, 0.999752581, 5.1530882e-05, 0.0218660161, -1.6285574e-05, 0.52529031, 0.093041338, 0.0139684565],
    [11, 0.999727011, -6.45119235e-06, 0.0230765548, -1.00390389e-05, 0.553026795, 0.109875262, 0.0148619544],
    [12, 0.999711633, 7.88707348e-06, 0.0239160564, -5.1070434e-05, 0.57511574, 0.127932638, 0.0165675692],
    [13, 0.999706864, -5.10493555e-05, 0.0245376192, -5.09008169e-06, 0.590399504, 0.146238863, 0.0182313081],
    [14, 0.999697328, -0.000118668417, 0.024931496, -2.85066089e-05, 0.598907888, 0.164910361, 0.0195784848],
    [15, 0.999698341, -0.000106273968, 0.0248909462, 2.71754743e-07, 0.60109216, 0.183965594, 0.0218427498],
    [16, 0.999702871, -0.000158263239, 0.02472407, -6.2398758e-06, 0.595867991, 0.202698529, 0.0242312774],
    [17, 0.999719381, -4.77898611e-05, 0.0240956545, 7.02364632e-05, 0.5847736, 0.222253203, 0.028374223],
    [18, 0.999735832, 7.95723172e-05, 0.0235081632, 5.54886101e-05, 0.56552875, 0.241364866, 0.0314281806],
    [19, 0.999766588, 7.62692362e-05, 0.0224408414, 7.25216669e-05, 0.540852129, 0.259090424, 0.0355016589],
    [20, 0.999795079, 6.56942648e-05, 0.0211460106, 7.59530012e-05, 0.509705424, 0.275871545, 0.0398730487],
    [21, 0.99982518, 6.71552625e-05, 0.019675374, 0.000149858242, 0.472526014, 0.291505963, 0.0441914909],
    [22, 0.999859333, 0.000273531215, 0.0179047622, 0.000225043535, 0.430396318, 0.307319403, 0.0493093655],
    [23, 0.999893248, 0.000319647137, 0.0160019491, 0.000289904536, 0.382861257, 0.320603251, 0.0537401587],
    [24, 0.999931753, 0.000300477259, 0.0136950891, 0.00036067504, 0.332459509, 0.331944078, 0.0583641566],
    [25, 0.999970376, 0.000233761617, 0.0114312479, 0.000401283032, 0.277179867, 0.341114879, 0.0620602667],
    [26, 0.999994159, 0.000209519334, 0.00911035761, 0.00046322553, 0.217915848, 0.348880529, 0.0661547333],
    [27, 1.00001156, 0.000209804828, 0.00695385737, 0.000531486585, 0.154807091, 0.354853272, 0.0698509067],
]
TRACK_BA_POSE_TOL = 1e-4
TRACK_BA_COST_TOL = 1e-3
# The JAX package on the CPU over the phase-4 frames (the port's renderer)
# with bf16 epipolar gathers, and with the matmul NLTGV2 adjoint:
#   JAX_PLATFORMS=cpu python scripts/jax_option_reference.py \
#       --option bfloat16|matmul
# (33 s and 37 s on the CPU; `--option none` gives 0.04437277, the f32
# gather run). Phase 13 (c) and (d) hold the port to each within
# JAX_BAND.
JAX_BF16_VGA = {"idepth_rmse": 0.0444833, "recall": 0.7385114,
                "coverage": 0.8503646}
JAX_MATMUL_VGA = {"idepth_rmse": 0.0443720, "recall": 0.7386841,
                  "coverage": 0.8501270}
# The external-pose acceptance protocol of tests/test_acceptance.py and
# tests/test_acceptance_stress.py: VGA, 200 frames, default FlameParams.
# Per run: the `make_sequence` keyword arguments that differ from the
# default sequence (room scene, strafe, texture gain 1, no exposure
# change), whether the engine matches with zero_mean_ssd, the dataset
# (tum and asl: the sequence written as a TUM or an ASL tree and read
# back through `--dataset tum|asl`), the JAX test, and that test's gates
# on the runner's summary, quoted. accept_argv gives the offline runner's
# arguments of a run. Every run also needs frames == 200 and failed == 0;
# exposure_b must beat exposure_a on rmse, recall and abs_rel
# (EXPOSURE_AB).
ACCEPT_FRAMES = 200
_DEFAULT_GATES = (("idepth_rmse", "<", 0.05), ("precision", ">", 0.95),
                  ("recall", ">", 0.80), ("coverage", ">", 0.85))
_ROTATION_GATES = (("idepth_rmse", "<", 0.05), ("precision", ">", 0.95),
                   ("recall", ">", 0.70), ("coverage", ">", 0.80))
_MAV_GATES = (("idepth_rmse", "<", 0.06), ("precision", ">", 0.95),
              ("recall", ">", 0.70), ("coverage", ">", 0.80))
ACCEPT_RUNS = {
    "default": dict(seq={}, test="tests/test_acceptance.py:22",
                    gates=_DEFAULT_GATES),
    "rotation": dict(seq=dict(motion="rotation"),
                     test="tests/test_acceptance_stress.py:38",
                     gates=_ROTATION_GATES),
    "low_texture": dict(seq=dict(texture_gain=0.3),
                        test="tests/test_acceptance_stress.py:49",
                        gates=_DEFAULT_GATES),
    "rotation_low_texture": dict(
        seq=dict(motion="rotation", texture_gain=0.3),
        test="tests/test_acceptance_stress.py:60", gates=_ROTATION_GATES),
    "exposure_a": dict(seq=dict(exposure_amp=0.5),
                       test="tests/test_acceptance_stress.py:74", gates=()),
    "exposure_b": dict(seq=dict(exposure_amp=0.5), zero_mean_ssd=True,
                       test="tests/test_acceptance_stress.py:74",
                       gates=(("idepth_rmse", "<", 0.07),
                              ("precision", ">", 0.95),
                              ("recall", ">", 0.70),
                              ("coverage", ">", 0.80))),
    "mav": dict(seq=dict(motion="mav"),
                test="tests/test_acceptance_stress.py:92",
                gates=_MAV_GATES + (("delta1", ">", 0.85),)),
    "primitives": dict(seq=dict(scene="primitives"),
                       test="tests/test_acceptance_stress.py:107",
                       gates=(("idepth_rmse", "<", 0.08),
                              ("precision", ">", 0.95),
                              ("recall", ">", 0.80),
                              ("coverage", ">", 0.88),
                              ("abs_rel", "<", 0.15))),
    "tum": dict(seq={}, dataset="tum",
                test="tests/test_acceptance_stress.py:125",
                gates=_DEFAULT_GATES),
    "asl": dict(seq=dict(motion="mav"), dataset="asl",
                test="tests/test_acceptance_stress.py:150",
                gates=_MAV_GATES),
}
# The JAX package on the CPU over the port's rendered frames of each
# ACCEPT_RUNS run (tum and asl: the trees the port's exporters write),
# default FlameParams, unrounded:
#   JAX_PLATFORMS=cpu python scripts/jax_acceptance_reference.py --run NAME
# "seconds" is each run's wall time on an 8-core CPU with the ten runs
# (and their --port runs) in parallel; primitives ran alone (its sphere
# path moved to float64 afterwards, the room scenes' frames unchanged).
# Phase 14 and the slow files tests/test_torch_acceptance{,_stress}.py
# hold the port to these.
JAX_ACCEPT_VGA200 = {
    "default": {"frames": 200, "failed": 0,
        "idepth_rmse": 0.029394804341718553, "precision": 1.0,
        "recall": 0.8439964029947916, "coverage": 0.8432585000991821,
        "abs_rel": 0.0230408925563097, "delta1": 0.9680987000465393,
        "seconds": 241.2},
    "rotation": {"frames": 200, "failed": 0,
        "idepth_rmse": 0.027800041614100338, "precision": 1.0,
        "recall": 0.7697056640624999, "coverage": 0.7479329705238342,
        "abs_rel": 0.042098917067050934, "delta1": 0.9616085886955261,
        "seconds": 194.6},
    "low_texture": {"frames": 200, "failed": 0,
        "idepth_rmse": 0.03187185681425035, "precision": 1.0,
        "recall": 0.848523583984375, "coverage": 0.8333626389503479,
        "abs_rel": 0.02671581506729126, "delta1": 0.9619232416152954,
        "seconds": 227.0},
    "rotation_low_texture": {"frames": 200, "failed": 0,
        "idepth_rmse": 0.030490153059363364, "precision": 1.0,
        "recall": 0.7864562825520836, "coverage": 0.7593717575073242,
        "abs_rel": 0.036500636488199234, "delta1": 0.9696929454803467,
        "seconds": 215.5},
    "exposure_a": {"frames": 200, "failed": 0,
        "idepth_rmse": 0.1731105378270149, "precision": 1.0,
        "recall": 0.7811815266927082, "coverage": 0.9025716185569763,
        "abs_rel": 0.46034201979637146, "delta1": 0.3316730856895447,
        "seconds": 165.0},
    "exposure_b": {"frames": 200, "failed": 0,
        "idepth_rmse": 0.04704366030171513, "precision": 1.0,
        "recall": 0.838181298828125, "coverage": 0.8610416650772095,
        "abs_rel": 0.07483015954494476, "delta1": 0.9239084124565125,
        "seconds": 199.1},
    "mav": {"frames": 200, "failed": 0, "idepth_rmse": 0.037572098430246115,
        "precision": 1.0, "recall": 0.7355970377604166,
        "coverage": 0.6648697853088379, "abs_rel": 0.028066487982869148,
        "delta1": 0.9608711004257202, "seconds": 213.9},
    "primitives": {"frames": 200, "failed": 0,
        "idepth_rmse": 0.062211409751325844, "precision": 0.9989923085219294,
        "recall": 0.8491672811163677, "coverage": 0.8736849427223206,
        "abs_rel": 0.0851355567574501, "delta1": 0.854595422744751,
        "seconds": 87.9},
    "tum": {"frames": 200, "failed": 0, "idepth_rmse": 0.02939503651112318,
        "precision": 1.0, "recall": 0.8439964029947916,
        "coverage": 0.8432585000991821, "abs_rel": 0.023041969165205956,
        "delta1": 0.9680948257446289, "seconds": 211.7},
    "asl": {"frames": 200, "failed": 0, "idepth_rmse": 0.03757419185712933,
        "precision": 1.0, "recall": 0.7355968749999999,
        "coverage": 0.6648697853088379, "abs_rel": 0.02806798368692398,
        "delta1": 0.9608711004257202, "seconds": 226.4},
}
EXPOSURE_AB = (("idepth_rmse", "<"), ("recall", ">"), ("abs_rel", "<"))


def accept_sequence(name):
    """An acceptance run's `make_sequence` keyword arguments, in full."""
    return dict(dict(motion="strafe", scene="room", texture_gain=1.0,
                     exposure_amp=0.0), **ACCEPT_RUNS[name]["seq"])


def accept_argv(name):
    """The offline runner's arguments of a synthetic acceptance run:
    `--dataset synthetic --resolution vga --frames 200` and one flag for
    each keyword argument of its sequence and option."""
    spec = ACCEPT_RUNS[name]
    argv = ["--dataset", "synthetic", "--resolution", "vga", "--frames",
            str(ACCEPT_FRAMES)]
    for key, value in spec["seq"].items():
        argv += ["--" + key.replace("_", "-"), str(value)]
    return argv + (["--zero-mean-ssd"] if spec.get("zero_mean_ssd") else [])


def gate_results(summary, gates):
    """[(key, op, bound, value, passed)] of a run's summary against
    gates."""
    out = []
    for key, op, bound in gates:
        v = summary[key]
        ok = v is not None and (v < bound if op == "<" else v > bound)
        out.append((key, op, bound, v, bool(ok)))
    return out


OCCLUDED = (24, 30)
# tests/test_tracking_recovery.py:141-142: a 7-frame occlusion fails at
# least its 7 frames and recovers within 8 more.
TRACK_FAILED_BOUNDS = (7, 15)
# The TPU v3 kernel's defaults; the port's v3 takes tri_block and
# long_thresh only (it has no block budgets).
V3_DEFAULTS = {"tri_block": 128, "s_blocks": 5, "l_blocks": 4,
               "long_thresh": 64.0}


def phase(name, **kv):
    print(json.dumps({"phase": name, **kv}), flush=True)


def port_kw(kw):
    """A kernel's keyword arguments without the TPU v3's block budgets."""
    return {k: v for k, v in kw.items() if k not in ("s_blocks", "l_blocks")}


def v3_budgets_hold(rc, args, H, kw):
    """Whether the TPU v3 kernel's block budgets (each clipped to the
    block count) would hold on this mesh, from the port's setup; the JAX
    wrapper runs v2 where they do not
    (flame_ros_tpu/ops/raster_pallas.py:275)."""
    kw = {**V3_DEFAULTS, **kw}
    _, _, nblk_s, long2, B = rc.v3_setup(
        *args, height=H, row_tile=2, tri_block=kw["tri_block"],
        long_thresh=kw["long_thresh"])
    n_blocks = args[1].shape[0] // B
    return (int(nblk_s.max()) <= min(kw["s_blocks"], n_blocks)
            and int(long2[1]) <= min(kw["l_blocks"], n_blocks))


def cuda_median_ms(fn, reps=30, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps=20, rounds=5):
    """Device time per call of fn, for a kernel launch that takes the
    host longer to issue than the card to run: `reps` calls queued behind
    a ~1 ms sleep kernel, so the events time the card alone (the gap
    between two back-to-back kernels included); the median of `rounds`.
    cuda_median_ms of one launch also times the host's issue of it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def make_meshes(triangulate, np, H=480, W=640, n=2048, T=4096, seed=0):
    """The phase-3 meshes, padded to T triangles. At 2048 uniform points
    (~4070 triangles) a 2-row tile has up to ~520 short candidates (over
    the TPU kernel's 384 budget); the engine's own topology is sparser
    (~2.6k triangles at VGA), which the 1300-point meshes match. The
    sliver mesh adds sub-pixel triangles (lowest ids) and two flat
    slivers above the mesh whose -1e-3 band reaches 7.7 px and the whole
    row beyond their bounding boxes; the multi-chunk mesh packs 740 more
    points into rows 200-260, so a tile's v4 range spans several staging
    chunks."""
    rng = np.random.default_rng(seed)

    def pad(pts, tris):
        tp = np.zeros((T, 3), np.int32)
        tp[:len(tris)] = tris[:T]
        tv = np.zeros(T, bool)
        tv[:min(len(tris), T)] = True
        pos = np.zeros((max(n, len(pts)), 2), np.float32)
        pos[:len(pts)] = pts
        return pos, tp, tv

    def ccw(p, t):
        a, b, c = (p[i].astype(np.float64) for i in t)
        cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return t if cross > 0 else [t[0], t[2], t[1]]

    def slivers(pts):
        extra, front, back = [], [], []

        def tri(*vs, into):
            i = len(pts) + len(extra)
            extra.extend(vs)
            into.append([i, i + 1, i + 2])

        for cx, cy in ((100, 100), (101, 100), (300, 200), (10, 2),
                       (500.5, 300.5)):
            tri((cx - 0.02, cy - 0.02), (cx + 0.03, cy - 0.01),
                (cx, cy + 0.03), into=front)
        tri((30, 1), (50, 1), (40, np.float32(1) + np.float32(1.3e-4)),
            into=back)
        tri((60, 2), (80, 2),
            (70, np.nextafter(np.float32(2), np.float32(3))), into=back)
        allp = np.concatenate([pts, np.asarray(extra, np.float32)])
        tris = [ccw(allp, t) for t in front] + triangulate(pts).tolist() \
            + [ccw(allp, t) for t in back]
        return pad(allp, np.asarray(tris, np.int32))

    def ysort(mesh):
        pos, tp, tv = mesh
        ymin = pos[tp, 1].min(1)
        ymin[~tv] = 1e9
        order = np.argsort(ymin, kind="stable")
        return pos, tp[order], tv[order]

    pts = rng.uniform(4, [W - 4, H - 4], (n, 2)).astype(np.float32)
    base = pad(pts, triangulate(pts))
    sparse = pts[:1300]
    # A point-free band: triangles bridging it are taller than the
    # 48-pixel long threshold.
    band = sparse[(sparse[:, 1] < 215) | (sparse[:, 1] > 275)]
    empty = (np.zeros((n, 2), np.float32), np.zeros((T, 3), np.int32),
             np.zeros(T, bool))
    dense = np.concatenate([sparse, rng.uniform(
        [4, 200], [W - 4, 260], (740, 2)).astype(np.float32)])
    # Per case, the keyword arguments of each kernel: the forced-fallback
    # case gives v3 budgets too small for the mesh (as in
    # tests/test_raster_pallas.py:97-107); v4 and v2 have none.
    return {"unsorted": (base, {}), "ysorted": (ysort(base), {}),
            "engine_density": (ysort(pad(sparse, triangulate(sparse))), {}),
            "long_triangles": (pad(band, triangulate(band)), {}),
            "forced_fallback": (base, {
                "v3": {"s_blocks": 1, "l_blocks": 1, "tri_block": 32}}),
            "empty": (empty, {}),
            "sliver": (slivers(sparse), {}),
            "multi_chunk": (ysort(pad(dense, triangulate(dense))), {})}


def bare_launch(rc, name, args, H, W, kw, lib=None, rt=2):
    """A launch of the kernel alone, its inputs prepared once (for the
    split of the wrapper's time between setup and kernel), from the
    package's library or `lib`, on tiles of `rt` rows. fn.out is its
    output, fn.slab_bytes the bytes of its inputs."""
    import torch
    lib = lib or rc._get_lib()
    out = torch.empty(H * W, dtype=torch.int32, device=args[0].device)
    work = torch.zeros(len(rc.WORK_SLOTS), dtype=torch.int32,
                       device=args[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    T = args[1].shape[0]
    if name == "v3":
        C, lo_blk, nblk_s, long2, B = rc.v3_setup(
            *args, height=H, row_tile=rt,
            tri_block=kw.get("tri_block", V3_DEFAULTS["tri_block"]),
            long_thresh=kw.get("long_thresh", V3_DEFAULTS["long_thresh"]))
        keep = (C, lo_blk, nblk_s, long2)

        def fn():
            lib.raster_v3_launch(C.data_ptr(), T, lo_blk.data_ptr(),
                                 nblk_s.data_ptr(), long2.data_ptr(), B,
                                 out.data_ptr(), H, W, rt, work.data_ptr(),
                                 stream)
    elif name == "v4":
        C, lo_pos, hi_pos, counts = rc.v4_setup(
            *args, height=H, row_tile=rt,
            long_thresh=kw.get("long_thresh", 48.0))
        keep = (C, lo_pos, hi_pos, counts)

        def fn():
            lib.raster_v4_launch(C.data_ptr(), T, lo_pos.data_ptr(),
                                 hi_pos.data_ptr(), counts.data_ptr(),
                                 out.data_ptr(), H, W, rt, work.data_ptr(),
                                 stream)
    else:
        C, bounds, B = rc.v2_setup(*args, height=H, width=W, row_tile=rt,
                                   tri_block=512)
        keep = (C, bounds)

        def fn():
            lib.raster_v2_launch(C.data_ptr(), T, bounds.data_ptr(), B,
                                 out.data_ptr(), H, W, rt, work.data_ptr(),
                                 stream)
    fn.keep = keep
    fn.out = out.reshape(H, W)
    fn.slab_bytes = sum(t.numel() * t.element_size() for t in keep)
    return fn


def y_overlap_tests(torch, pos, tris, tv, H, W, rt=2):
    """The inside tests of a kernel that culls in y only (the measure
    the bound once used): per tile of rt rows, the valid triangles whose
    y-range overlaps it, times its pixels."""
    t = tris.long()
    ys = torch.stack([pos[t[:, k], 1] for k in range(3)], -1)
    ymin = torch.sort(ys.min(-1).values[tv]).values
    ymax = torch.sort(ys.max(-1).values[tv]).values
    y0 = torch.arange(H // rt, device=pos.device, dtype=torch.float32) * rt
    n = (torch.searchsorted(ymin, y0 + rt)
         - torch.searchsorted(ymax, y0)).clamp(min=0)
    return int(n.sum()) * rt * W


def bbox_pairs(torch, pos, tris, tv, H, W):
    """The inside tests the id buffer needs on this data: the (pixel,
    valid triangle) pairs whose pixel lies in the triangle's bounding
    box."""
    t = tris.long()[tv]
    p = pos[t]                                   # [n, 3, 2]
    lo = torch.ceil(p.min(1).values).clamp(min=0)
    hi = torch.floor(p.max(1).values)
    hi = torch.minimum(hi, torch.tensor([W - 1.0, H - 1.0],
                                        device=pos.device))
    n = (hi - lo + 1).clamp(min=0)
    return int((n[:, 0] * n[:, 1]).sum())


def order_split(torch, rc, pos, tris, ids_v4, ids_plain):
    """Pixels where the v4 id buffer and the plain formulation's differ,
    and whether each is explained by their evaluation orders alone: v4's
    answer passes the inside test in v4's order x*a + (y*b + c), the
    plain formulation's passes in its order (x*a + y*b) + c, and one of
    the two triangles passes in one order and fails in the other (a
    pixel within rounding of the -1e-3 band of an edge)."""
    px = (ids_v4 != ids_plain).nonzero()
    if not len(px):
        return 0, True
    y = px[:, 0].to(torch.float32)[:, None]
    x = px[:, 1].to(torch.float32)[:, None]

    def inside(ids, v4_order):
        t = tris[ids.clamp(min=0).long()].long()
        c = [pos[t[:, k]] for k in range(3)]
        ok = ids >= 0
        for p0, p1 in ((c[0], c[1]), (c[1], c[2]), (c[2], c[0])):
            a, b, cc = rc.edge_coeffs(p0, p1)
            a, b, cc = a[:, None], b[:, None], cc[:, None]
            e = x * a + (y * b + cc) if v4_order else (x * a + y * b) + cc
            ok = ok & (e[:, 0] >= rc.EPS)
        return ok

    a = ids_v4[px[:, 0], px[:, 1]]
    b = ids_plain[px[:, 0], px[:, 1]]
    a4, a2, b4, b2 = (inside(i, o) for i in (a, b) for o in (True, False))
    explained = ((a4 | (a < 0)) & (b2 | (b < 0))
                 & ((a4 != a2) | (b4 != b2)))
    return len(px), bool(explained.all())


def check_idmap(engine, frame):
    """Recompute the id buffer of the frame the engine has just rastered
    from its own state: the plain v4 version must equal the kernel's bit
    for bit, and the plain formulation `ops/raster.py::rasterize_tri_ids`
    may differ only on pixels that the two evaluation orders split
    (order_split). Call it while the state still holds that raster's
    inputs: after a non-poseframe, or on a poseframe before its topology
    install. Returns (pixels split, the raster's inputs)."""
    import torch
    from flame_ros_torch.models.engine import _smooth_pd_setup
    from flame_ros_torch.ops import raster as raster_ops
    from flame_ros_torch.ops import raster_cuda as rc
    cam = engine.cam
    st = engine.state
    tri_fresh, _, _ = _smooth_pd_setup(st, params=engine.params)
    _, pvalid = raster_ops.triangle_planes(st.vtx_uv, st.vtx_x, st.tris,
                                           tri_fresh)
    args = (st.vtx_uv, st.tris, pvalid)
    kw = dict(height=cam.height, width=cam.width)
    if not torch.equal(rc.rasterize_tri_ids_v4_ref(*args, **kw),
                       st.last_idmap):
        raise AssertionError(f"frame {frame}: main-path id buffer "
                             "differs from plain v4")
    n_px, explained = order_split(torch, rc, st.vtx_uv, st.tris,
                                  st.last_idmap,
                                  raster_ops.rasterize_tri_ids(*args, **kw))
    if not explained:
        raise AssertionError(f"frame {frame}: the id buffer differs from "
                             "the plain formulation beyond evaluation order")
    return n_px, (st.vtx_uv.clone(), st.tris.clone(), pvalid)


def drive_main_path(engine, seq, out_dir):
    """run_offline over `seq` with `engine`. Times each frame on the host
    clock from its start to the end of its stats read (a device sync);
    after six non-poseframes spread over the run, recomputes that frame's
    id buffer (check_idmap), records whether the TPU v3's budgets would
    hold on that frame's mesh, and keeps the raster's inputs.
    Returns (RunResult, ms per frame, checked frame ids, pixels that
    differ from the plain formulation per checked frame, v3 fits per
    checked frame, raster inputs per checked frame, telemetry)."""
    import numpy as np
    from flame_ros_torch.frontends.offline_runner import (run_offline,
                                                          synthetic_frames)
    from flame_ros_torch.ops import raster_cuda as rc
    cam = engine.cam
    pf_every = engine.params.input.poseframe_subsample_factor
    starts, ends, checked, v3_fits, inputs, split = [], [], [], [], [], []

    def frames():
        for i, f in enumerate(synthetic_frames(seq)):
            if i:
                ends.append(time.perf_counter())
            # After a non-poseframe the state still holds the inputs of
            # that frame's raster (no topology install since). Frames 7,
            # 17, ..., 57: the mesh exists from the second poseframe on.
            if (i - 1) % 10 == 7 and (i - 1) % pf_every != 0:
                n_px, args = check_idmap(engine, i - 1)
                split.append(n_px)
                checked.append(i - 1)
                inputs.append(args)
                v3_fits.append(v3_budgets_hold(rc, args, cam.height, {}))
            starts.append(time.perf_counter())
            yield f
        ends.append(time.perf_counter())

    res = run_offline(frames(), cam, engine.params, out_dir=out_dir,
                      engine=engine)
    with open(os.path.join(out_dir, "telemetry.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ms = (np.asarray(ends) - np.asarray(starts)) * 1e3
    return res, ms, checked, split, v3_fits, inputs, recs


def launch_counts(rc, dev):
    """Wrapper launch counts and device work counters, by kernel."""
    return ({"v4": rc.rasterize_tri_ids_v4.launches,
             "v2": rc.rasterize_tri_ids_v2.launches,
             "v3": rc.rasterize_tri_ids_v3.launches},
            dict(zip(("v4", "v2", "v3"), rc.work_counters(dev).tolist())))


def stream_windows(engine, frames, gts, win, depth=2):
    """The streaming loop of bench.py's run_sustained: windows of `win`
    host frames, each prefetched `depth` windows ahead (pinned pack and
    copy-stream upload), dispatched with update_window(prefetched=...),
    and its stats read back (flush_window_stats, one device-to-host copy
    that waits for the window). Returns per window the host seconds from
    the prefetch that starts its iteration to its stats read, and its
    per-frame stats rows."""
    n_win = len(frames) // win

    def prefetch(w):
        s = slice(w * win, (w + 1) * win)
        return engine.prefetch_window(frames[s], gts[s])

    pending = [prefetch(w) for w in range(min(depth, n_win))]
    secs, rows = [], []
    for w in range(n_win):
        t0 = time.perf_counter()
        if w + depth < n_win:
            pending.append(prefetch(w + depth))
        assert engine.update_window(prefetched=pending.pop(0))
        rows.append(engine.flush_window_stats())
        secs.append(time.perf_counter() - t0)
    return secs, rows


def jax_band(res, ref):
    """A run's distance from the JAX package's numbers (rmse relative,
    recall and coverage absolute) and whether each is within JAX_BAND."""
    diff = {"idepth_rmse": abs(res.mean_rmse - ref["idepth_rmse"])
            / ref["idepth_rmse"],
            "recall": abs(res.mean_recall - ref["recall"]),
            "coverage": abs(res.final_coverage - ref["coverage"])}
    return diff, all(diff[k] <= JAX_BAND[k] for k in diff)


def pctl(np, xs, q):
    return float(np.percentile(np.asarray(xs, float), q))


def drive_nodelet(node, seq, n, pace_s=0.0):
    """Push n frames of seq (images and depths stay on the card) from a
    producer thread, every pace_s seconds (0: a burst), while the
    nodelet's consumer thread runs, and wait for every stats record.
    Returns (accepted flags, stats records, meshes' frame ids, heartbeat
    transitions, health before the first and after the last frame)."""
    import threading
    q = seq.poses.q.cpu().numpy()
    t = seq.poses.t.cpu().numpy()
    stats, mesh_ids, beats, accepted = [], [], [], []
    done = threading.Event()

    def on_stats(rec):
        stats.append(rec)
        if len(stats) == n:
            done.set()

    def produce():
        for i in range(n):
            accepted.append(node.push_frame(
                i, float(seq.timestamps[i]), q[i], t[i], seq.images[i],
                seq.depths[i]))
            if pace_s:
                time.sleep(pace_s)

    node.on_stats.append(on_stats)
    node.on_mesh.append(lambda i, _t, _m: mesh_ids.append(i))
    node.on_heartbeat.append(beats.append)
    health0 = node.health
    node.start()
    producer = threading.Thread(target=produce)
    producer.start()
    producer.join()
    if not done.wait(timeout=300):
        raise AssertionError(f"nodelet processed {len(stats)} of {n}")
    health1 = node.health
    node.stop()
    return accepted, stats, mesh_ids, beats, health0, health1


def run_engine(engine, seq, lo, hi, SE3):
    """Frames lo..hi-1 of seq through Flame.update as run_offline feeds
    them (a poseframe every poseframe_subsample_factor frames, GT depth),
    each frame's stats read back. Returns the stats records."""
    q = seq.poses.q.cpu().numpy()
    t = seq.poses.t.cpu().numpy()
    pf_every = engine.params.input.poseframe_subsample_factor
    recs = []
    for i in range(lo, hi):
        assert engine.update(float(seq.timestamps[i]), i,
                             SE3.from_quat_trans(q[i], t[i]), seq.images[i],
                             i % pf_every == 0, gt_depth=seq.depths[i])
        recs.append(engine.flush_stats())
        assert recs[-1]["health"] == 1.0, (i, recs[-1])
    return recs


def serve_round_trip(srv, seq, n):
    """Client 1 streams n uint8 frames to the running server `srv` and
    reads every stats message, then the idepth map; client 2 polls meshes
    meanwhile. Then srv.stop(), and each client must see its connection
    closed. Returns (stats headers, idepth map, the serving engine's own
    map read before stop, meshes polled, connections closed)."""
    import io
    import socket
    import threading
    import numpy as np
    import torch
    from flame_ros_torch.frontends.serve import recv_msg, send_msg
    imgs = torch.clamp(seq.images[:n], 0, 255).to(torch.uint8).cpu().numpy()
    q = seq.poses.q.cpu().numpy()
    t = seq.poses.t.cpu().numpy()
    c1, c2 = (socket.create_connection(("127.0.0.1", srv.port), timeout=60)
              for _ in range(2))
    meshes, polling = [], threading.Event()
    polling.set()

    def poll():
        while polling.is_set():
            send_msg(c2, {"type": "get_mesh"})
            while True:
                h, payload = recv_msg(c2)
                if h is None:
                    return
                if h["type"] == "mesh":
                    meshes.append(dict(np.load(io.BytesIO(payload))))
                    break
            time.sleep(0.05)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        for i in range(n):
            send_msg(c1, {"type": "frame", "img_id": i,
                          "time": float(seq.timestamps[i]),
                          "quat": q[i].tolist(), "trans": t[i].tolist(),
                          "shape": list(imgs[i].shape), "dtype": "uint8"},
                     imgs[i].tobytes())
        stats = []
        while len(stats) < n:
            h, _ = recv_msg(c1)
            assert h is not None, "server closed the stream early"
            if h["type"] == "stats":
                stats.append(h)
        polling.clear()
        poller.join(60)
        send_msg(c1, {"type": "get_idepth"})
        while True:
            h, payload = recv_msg(c1)
            if h["type"] == "idepth":
                break
        m = np.frombuffer(payload, np.float32).reshape(h["shape"])
        own = srv.node.engine.get_inverse_depth_map()
    finally:
        polling.clear()
        srv.stop()

    def closed(c):
        c.settimeout(20)
        try:
            while recv_msg(c)[0] is not None:
                pass
            return True
        except ConnectionResetError:
            return True
        except OSError:
            return False
        finally:
            c.close()

    return stats, m, own, meshes, [closed(c1), closed(c2)]


def write_tum_asl(seq, cam, root, np, torch):
    """phase 4's frames as a TUM tree (association file, RGB and 16-bit
    depth PNGs, a CameraInfo YAML) and an EuRoC/ASL tree (camera, depth
    and pose sensor folders, identity extrinsics). Returns the paths."""
    import cv2
    import yaml
    n = len(seq)
    g8 = torch.clamp(seq.images, 0, 255).to(torch.uint8).cpu().numpy()
    d16 = np.round(seq.depths.cpu().numpy() * 5000.0).astype(np.uint16)
    q = seq.poses.q.cpu().numpy().astype(np.float64)
    t = seq.poses.t.cpu().numpy().astype(np.float64)
    tum = os.path.join(root, "tum")
    asl = os.path.join(root, "asl", "mav0")
    dirs = {k: os.path.join(asl, k) for k in
            ("cam0", "depth0", "state_groundtruth_estimate0")}
    for d in (os.path.join(tum, "rgb"), os.path.join(tum, "depth"),
              os.path.join(dirs["cam0"], "data"),
              os.path.join(dirs["depth0"], "data"),
              dirs["state_groundtruth_estimate0"]):
        os.makedirs(d, exist_ok=True)
    eye = {"rows": 4, "cols": 4, "data": np.eye(4).ravel().tolist()}
    K = cam.K.astype(np.float64)
    with open(os.path.join(tum, "calib.yaml"), "w") as f:
        yaml.safe_dump({
            "image_width": cam.width, "image_height": cam.height,
            "camera_matrix": {"rows": 3, "cols": 3,
                              "data": K.ravel().tolist()},
            "projection_matrix": {
                "rows": 3, "cols": 4,
                "data": np.hstack([K, np.zeros((3, 1))]).ravel().tolist()},
            "distortion_coefficients": {"rows": 1, "cols": 5,
                                        "data": [0.0] * 5}}, f)
    for k, meta in (("cam0", {"sensor_type": "camera", "T_BS": eye,
                              "intrinsics": [cam.fx, cam.fy, cam.cx, cam.cy],
                              "resolution": [cam.width, cam.height],
                              "distortion_coefficients": [0.0] * 4}),
                    ("depth0", {"sensor_type": "camera", "T_BS": eye,
                                "depth_scale_factor": 5000.0}),
                    ("state_groundtruth_estimate0",
                     {"sensor_type": "visual-inertial", "T_BS": eye})):
        with open(os.path.join(dirs[k], "sensor.yaml"), "w") as f:
            yaml.safe_dump(meta, f)
    lines, cam_rows, pose_rows = [], [], []
    for i in range(n):
        ts = float(seq.timestamps[i])
        ns = 1_000_000_000 + round(ts * 1e9)
        rgb = np.repeat(g8[i][..., None], 3, -1)
        cv2.imwrite(os.path.join(tum, "rgb", f"{i}.png"), rgb)
        cv2.imwrite(os.path.join(tum, "depth", f"{i}.png"), d16[i])
        cv2.imwrite(os.path.join(dirs["cam0"], "data", f"{ns}.png"), g8[i])
        cv2.imwrite(os.path.join(dirs["depth0"], "data", f"{ns}.png"),
                    d16[i])
        # Shortest round-trip decimal of each value.
        qw, qx, qy, qz, tx, ty, tz = (repr(float(v))
                                      for v in (*q[i], *t[i]))
        lines.append(f"{ts!r} {tx} {ty} {tz} {qx} {qy} {qz} {qw} "
                     f"{ts!r} rgb/{i}.png {ts!r} depth/{i}.png")
        cam_rows.append(f"{ns},{ns}.png")
        pose_rows.append(f"{ns},{tx},{ty},{tz},{qw},{qx},{qy},{qz}")
    with open(os.path.join(tum, "assoc.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for k, rows in (("cam0", cam_rows), ("depth0", cam_rows),
                    ("state_groundtruth_estimate0", pose_rows)):
        with open(os.path.join(dirs[k], "data.csv"), "w") as f:
            f.write("#timestamp,data\n" + "\n".join(rows) + "\n")
    return (os.path.join(tum, "assoc.txt"), os.path.join(tum, "calib.yaml"),
            dirs["state_groundtruth_estimate0"], dirs["cam0"],
            dirs["depth0"])


def live_frontend(seq, recs4, res4, params, cam, dev, out):
    """Phase 7 over phase 4's sequence `seq`, whose per-frame telemetry
    is recs4 and whose RunResult is res4."""
    import contextlib
    import io
    import numpy as np
    import torch
    from flame_ros_torch.config import FlameParams
    from flame_ros_torch.eval.metrics import TruthStats
    from flame_ros_torch.frontends import offline_runner
    from flame_ros_torch.frontends.nodelet import FlameNodelet, Health
    from flame_ros_torch.frontends.serve import FlameServer
    from flame_ros_torch.geometry.se3 import SE3
    from flame_ros_torch.models.engine import Flame, state_to_numpy
    from flame_ros_torch.ops import raster_cuda as rc
    n = len(seq)

    def counts_ok(min_frames):
        launches, work = launch_counts(rc, dev)
        assert launches["v4"] >= min_frames, launches
        assert work == {"v4": launches["v4"], "v2": 0, "v3": 0}, work
        return launches, work

    # (a) nodelet: a burst from a producer thread, then camera rate.
    keys = ("idepth_rmse", "true_pos", "false_pos", "false_neg", "coverage",
            "num_tris")
    node = FlameNodelet(cam, params, queue_size=n, eval_gt_depth=True,
                        device=dev)
    rc.reset_counters()
    accepted, stats, mesh_ids, beats, h0, h1 = drive_nodelet(node, seq, n)
    launches_a, work_a = counts_ok(n)
    assert all(accepted) and node.queue.num_dropped == 0, accepted
    assert [r["img_id"] for r in stats] == list(range(n))
    assert mesh_ids == list(range(n)), mesh_ids
    assert h0 == Health.READY and h1 == Health.READY, (h0, h1, beats)
    assert Health.FAIL not in beats, beats
    differ = [(i, k) for i, (a, b) in enumerate(zip(stats, recs4))
              for k in keys if a[k] != b[k]]
    assert not differ, f"nodelet != phase 4 at (frame, key) {differ[:8]}"
    truth = [TruthStats.from_record(r) for r in stats]
    node_p = FlameNodelet(cam, params, queue_size=n, eval_gt_depth=True,
                          device=dev)
    accepted_p, stats_p, _, beats_p, _, h1_p = drive_nodelet(
        node_p, seq, n, pace_s=1.0 / 30)
    assert all(accepted_p) and len(stats_p) == n
    steady, steady_p = stats[5:], stats_p[5:]
    phase("live_nodelet", frames=len(stats), dropped=node.queue.num_dropped,
          health_start=h0.name, health_end=h1.name,
          heartbeats=[b.name for b in beats],
          equal_to_main_path_keys=list(keys),
          mean_rmse=float(np.nanmean([t.rmse for t in truth])),
          mean_recall=float(np.nanmean([t.recall for t in truth])),
          final_coverage=stats[-1]["coverage"],
          main_path_mean_rmse=res4.mean_rmse,
          main_path_mean_recall=res4.mean_recall,
          main_path_final_coverage=res4.final_coverage,
          process_frame_ms_p50=pctl(np, [r["process_frame_ms"]
                                         for r in steady], 50),
          process_frame_ms_p95=pctl(np, [r["process_frame_ms"]
                                         for r in steady], 95),
          latency_ms_p50=pctl(np, [r["latency_ms"] for r in steady], 50),
          latency_ms_p95=pctl(np, [r["latency_ms"] for r in steady], 95),
          fps_end=stats[-1]["fps"], launches=launches_a, work=work_a,
          paced_fps_in=30, paced_dropped=node_p.queue.num_dropped,
          paced_health_end=h1_p.name,
          paced_heartbeats=[b.name for b in beats_p],
          paced_process_frame_ms_p50=pctl(
              np, [r["process_frame_ms"] for r in steady_p], 50),
          paced_process_frame_ms_p95=pctl(
              np, [r["process_frame_ms"] for r in steady_p], 95),
          paced_latency_ms_p50=pctl(np, [r["latency_ms"] for r in steady_p],
                                    50),
          paced_latency_ms_p95=pctl(np, [r["latency_ms"] for r in steady_p],
                                    95))

    # (b) pose-graph edits and a checkpoint at frame 30.
    mid = n // 2
    ckpt = os.path.join(out, f"frame{mid}.npz")
    rc.reset_counters()
    eng_a = Flame(cam.width, cam.height, cam=cam, params=params, device=dev)
    recs_a = run_engine(eng_a, seq, 0, mid, SE3)
    eng_a.save_checkpoint(ckpt)
    eng_b = Flame(cam.width, cam.height, cam=cam, params=params, device=dev)
    eng_b.load_checkpoint(ckpt)
    sa, sb = state_to_numpy(eng_a.state), state_to_numpy(eng_b.state)
    assert all(np.array_equal(sa[k], sb[k]) for k in sa), "load != save"
    node_c = FlameNodelet(cam, params, device=dev)
    node_c.engine.load_checkpoint(ckpt)
    s0 = state_to_numpy(node_c.engine.state)
    slots = np.flatnonzero(s0["kf_valid"])
    slots = slots[np.argsort(s0["kf_ids"][slots])]
    ids = s0["kf_ids"][slots]
    tau = [0.01, -0.005, 0.002, 0.002, -0.001, 0.003]
    step = SE3.exp(np.array(tau, np.float32))
    moved = SE3(torch.from_numpy(s0["kf_q"][slots]),
                torch.from_numpy(s0["kf_t"][slots])) @ step
    node_c.poseframe_callback(ids, moved)
    s1 = state_to_numpy(node_c.engine.state)
    want = {k: s0[k].copy() for k in ("kf_q", "kf_t")}
    want["kf_q"][slots] = moved.q.numpy()
    want["kf_t"][slots] = moved.t.numpy()
    for k in ("kf_q", "kf_t"):
        assert np.array_equal(s1[k], want[k]), k
    for k in ("kf_valid", "feat.valid"):
        assert np.array_equal(s1[k], s0[k]), k
    node_c.poseframe_callback(ids[1:], SE3(moved.q[1:], moved.t[1:]))
    s2 = state_to_numpy(node_c.engine.state)
    dead = ~np.isin(s1["kf_ids"], ids[1:])
    assert np.array_equal(s2["kf_valid"], s1["kf_valid"] & ~dead)
    assert np.array_equal(s2["feat.valid"],
                          s1["feat.valid"] & ~dead[s1["feat.kf_idx"]])
    for k in ("kf_q", "kf_t"):
        assert np.array_equal(s2[k], s1[k]), k
    assert node_c._pf_subsample == int(ids[1] - ids[0])
    recs_c = run_engine(node_c.engine, seq, mid, n, SE3)
    recs_a += run_engine(eng_a, seq, mid, n, SE3)
    recs_b = run_engine(eng_b, seq, mid, n, SE3)
    launches_b, work_b = counts_ok(n + 2 * (n - mid))
    assert torch.equal(eng_a.state.last_idmap, eng_b.state.last_idmap)
    ia, ib = eng_a.get_inverse_depth_map(), eng_b.get_inverse_depth_map()
    assert np.array_equal(ia, ib, equal_nan=True), "resumed idepth differs"
    sa, sb = state_to_numpy(eng_a.state), state_to_numpy(eng_b.state)
    state_differs = [k for k in sa if not np.array_equal(sa[k], sb[k])]
    phase("live_posegraph_checkpoint", checkpoint_frame=mid,
          checkpoint_bytes=os.path.getsize(ckpt),
          live_poseframe_ids=ids.tolist(),
          moved_step=tau,
          pruned_id=int(ids[0]),
          features_killed=int(s1["feat.valid"].sum() - s2["feat.valid"].sum()),
          edits_equal_numpy=True, resumed_idmap_equal=True,
          resumed_idepth_equal=True, resumed_state_differs=state_differs,
          uninterrupted_equals_main_path=all(
              a[k] == b[k] for a, b in zip(recs_a, recs4) for k in keys),
          edited_mean_rmse_after=float(np.nanmean(
              [TruthStats.from_record(r).rmse for r in recs_c])),
          uninterrupted_mean_rmse_after=float(np.nanmean(
              [TruthStats.from_record(r).rmse for r in recs_a[mid:]])),
          launches=launches_b, work=work_b)

    # (c) the server on 127.0.0.1.
    n_srv = min(30, n)
    srv = FlameServer(cam, params, port=0, queue_size=n_srv + 2, device=dev)
    rc.reset_counters()
    t0 = time.perf_counter()
    srv.start()
    warmup_s = time.perf_counter() - t0
    sstats, m, own, meshes, closed = serve_round_trip(srv, seq, n_srv)
    launches_c, work_c = counts_ok(n_srv)
    assert [h["img_id"] for h in sstats] == list(range(n_srv))
    assert np.array_equal(m, own, equal_nan=True), "idepth over the wire"
    assert meshes and all(
        {"vertices_px", "idepths", "normals", "triangles", "tri_validity",
         "edges", "K"} <= set(x) for x in meshes)
    assert np.array_equal(meshes[-1]["K"], cam.K)
    assert closed == [True, True], closed
    assert all(a[k] == b[k] for a, b in zip(sstats, recs4)
               for k in ("coverage", "num_tris")), "server != phase 4"
    phase("live_server", frames=len(sstats), warmup_s=warmup_s,
          meshes_polled=len(meshes),
          idepth_equal=True, connections_closed_on_stop=closed,
          coverage_equals_main_path=True,
          process_frame_ms_p50=pctl(np, [h["process_frame_ms"]
                                         for h in sstats[5:]], 50),
          latency_ms_p50=pctl(np, [h["latency_ms"] for h in sstats[5:]],
                              50),
          launches=launches_c, work=work_c)

    # (d) patch-mode epipolar and the truth harness against the JAX runs.
    patch = FlameParams.from_yaml(os.path.join(REPO, "cfg",
                                               "epipolar_patch.yaml"))
    assert patch.engine.epipolar_mode == "patch"
    rows = {}
    for name, prm, truth_in, ref in (("patch", patch, False, JAX_PATCH_VGA),
                                     ("truth", params, True, JAX_TRUTH_VGA)):
        rc.reset_counters()
        r = offline_runner.run_offline(
            offline_runner.synthetic_frames(seq), cam, prm,
            pass_in_truth=truth_in, device=dev)
        launches_d, work_d = counts_ok(n)
        diff, ok = jax_band(r, ref)
        assert r.frames_processed == n and r.frames_failed == 0, r
        assert ok, (name, r, diff)
        rows[name] = dict(mean_rmse=r.mean_rmse, mean_recall=r.mean_recall,
                          mean_precision=r.mean_precision,
                          final_coverage=r.final_coverage,
                          final_abs_rel=r.final_abs_rel,
                          final_delta1=r.final_delta1, jax_cpu=ref,
                          diff=diff, launches=launches_d, work=work_d)
    phase("live_patch_truth", band=JAX_BAND, **rows)

    # (e) the TUM and ASL loaders and CLI routes.
    assoc, calib, pose_dir, rgb_dir, depth_dir = write_tum_asl(
        seq, cam, os.path.join(out, "datasets"), np, torch)
    runs = {}
    for name, fn, argv in (
            ("tum", offline_runner.main_tum,
             ["--input", assoc, "--calib", calib]),
            ("asl", offline_runner.main_asl,
             ["--pose-path", pose_dir, "--rgb-path", rgb_dir,
              "--depth-path", depth_dir])):
        rc.reset_counters()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            r = fn(argv + ["--device", str(dev)])
        summary = json.loads(printed.getvalue().strip().splitlines()[-1])
        launches_e, work_e = counts_ok(n)
        assert set(summary) == {"frames", "failed", "fps", "idepth_rmse",
                                "precision", "recall", "coverage",
                                "abs_rel", "delta1"}, summary
        assert r.frames_processed == n and r.frames_failed == 0, r
        runs[name] = (r, summary, launches_e, work_e)
    rt, ra = runs["tum"][0], runs["asl"][0]
    assert (rt.mean_rmse, rt.mean_recall, rt.final_coverage) == \
        (ra.mean_rmse, ra.mean_recall, ra.final_coverage), (rt, ra)
    # Same images and poses as phase 4; only the depth is quantized to
    # 1/5000 m, which moves the GT metrics and not the state.
    assert rt.final_coverage == res4.final_coverage, (rt, res4)
    assert abs(rt.mean_rmse - res4.mean_rmse) <= 0.01 * res4.mean_rmse
    phase("live_datasets", **{k: dict(summary=s, launches=la, work=w)
                              for k, (_, s, la, w) in runs.items()},
          tum_equals_asl=True, coverage_equals_main_path=True,
          rmse_rel_diff_main_path=abs(rt.mean_rmse - res4.mean_rmse)
          / res4.mean_rmse)


def device_events(fn):
    """(device events, device-busy ms) of one call of fn, from
    torch.profiler: kernels, copies and fills on the card. Only device
    activity is recorded: with the host's ops too, phase 12's ten
    profiled calls took 120.2 s on an H100 (700 W) against 17.4 s, for
    the same launch counts within a few and the same busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, busy = 0, 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            n += e.count
            for k in ("self_device_time_total", "self_cuda_time_total"):
                v = getattr(e, k, None)
                if v is not None:
                    busy += v / 1e3
                    break
    return n, busy


def no_sync(fn):
    """Call fn with CUDA synchronizing operations made errors, so that a
    host sync inside it fails the phase."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return True


class EventTimer:
    """Wraps a function of a module with two CUDA events per call (only
    the events are kept: the calls may run under torch.func.vmap)."""

    def __init__(self, mod, name):
        self.mod, self.name = mod, name
        self.fn = getattr(mod, name)
        self.events = []

    def call(self, *args, **kw):
        import torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.fn(*args, **kw)
        b.record()
        self.events.append((a, b))
        return out

    __call__ = call

    def __enter__(self):
        setattr(self.mod, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


class CallTimer(EventTimer):
    """An EventTimer that also keeps each call's host time (the time to
    launch it), the last call's arguments and every call's result."""

    def __init__(self, mod, name):
        super().__init__(mod, name)
        self.host_s, self.outs, self.last = [], [], None

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.call(*args, **kw)
        self.host_s.append(time.perf_counter() - t0)
        self.outs.append(out)
        self.last = (args, kw)
        return out


def track_bands(res, ref, keys):
    """A tracking run's distance from the JAX package's numbers (JAX_BAND;
    ATE within max(25 % relative, 1e-3 m)) and whether those of `keys`
    hold."""
    diff, _ = jax_band(res, ref)
    diff["ate_rmse"] = abs(res.ate_rmse - ref["ate_rmse"])
    band = dict(JAX_BAND, ate_rmse=max(0.25 * ref["ate_rmse"], 1e-3))
    return diff, all(diff[k] <= band[k] for k in keys)


def tracking_path(seq, ms4, params, cam, dev, out):
    """Phase 8 over phase 4's sequence `seq`, whose per-frame host ms
    (steady frames) are ms4. Returns the summaries and each run's
    per-frame host ms (steady, tracked frames)."""
    import numpy as np
    import torch
    from flame_ros_torch.frontends import nodelet as nodelet_mod
    from flame_ros_torch.frontends import offline_runner
    from flame_ros_torch.frontends.nodelet import FlameNodelet
    from flame_ros_torch.ops import raster_cuda as rc
    n = len(seq)
    summaries, frame_lists = {}, {}
    for name, occlude, ref in (("clean", None, JAX_TRACK_VGA),
                               ("occluded", OCCLUDED, JAX_OCCLUDE_VGA)):
        node = FlameNodelet(cam, params, pose_source="tracking",
                            eval_gt_depth=True, trajectory_cap=0, device=dev)
        assert node.engine.params.engine.pallas_raster_kernel == "v4"
        frame_ms, process = [], node._process

        def timed(frame, process=process, frame_ms=frame_ms):
            # The frame's tracking, engine update and stats read (a sync).
            t0 = time.perf_counter()
            process(frame)
            frame_ms.append((frame.img_id, (time.perf_counter() - t0) * 1e3))

        node._process = timed
        stats = []
        node.on_stats.append(stats.append)
        frames = offline_runner.synthetic_frames(seq)
        if occlude:
            frames = offline_runner.with_occlusion(frames, *occlude)
        out_dir = os.path.join(out, f"tracking_{name}")
        rc.reset_counters()
        with CallTimer(nodelet_mod, "track_frame") as tf, \
                CallTimer(nodelet_mod, "ring_relocalize") as rr:
            res = offline_runner.run_offline_tracking(
                frames, cam, params, out_dir=out_dir, device=dev, node=node)
        launches, work = launch_counts(rc, dev)
        ids = [i for i, _, _ in node.trajectory]
        failed = [r["img_id"] for r in stats if r.get("tracking_failed")]
        health = [r["health"] for r in stats if "health" in r]
        assert res.frames_failed == 0 and node.engine.num_failed_frames == 0
        assert len(health) == len(ids) and all(h == 1.0 for h in health)
        assert launches["v4"] >= len(ids), launches
        assert launches["v2"] == 0 and launches["v3"] == 0, launches
        assert work == {"v4": launches["v4"], "v2": 0, "v3": 0}, work
        if occlude:
            occ = set(range(occlude[0], occlude[1] + 1))
            assert occ <= set(failed), failed
            assert not occ & set(ids), ids
            lo, hi = TRACK_FAILED_BOUNDS
            assert lo <= res.track_failed_frames <= hi, res
            assert len(ids) + res.track_failed_frames == n
        else:
            assert res.frames_processed == n and ids == list(range(n)), \
                (res, failed)
            assert res.track_failed_frames == 0 and not failed, failed
        # (b): ATE and rmse in the bands; recall and coverage recorded.
        diff, ok = track_bands(res, ref, (
            ("ate_rmse", "idepth_rmse") if occlude else
            ("ate_rmse", "idepth_rmse", "recall", "coverage")))
        assert ok, (name, res, diff)
        # One track_frame and one ring_relocalize call, standalone at the
        # run's last inputs: no host sync inside, launches per call.
        args, kw = tf.last
        no_sync(lambda: nodelet_mod.track_frame(*args, **kw))
        tf_events, tf_busy = device_events(
            lambda: nodelet_mod.track_frame(*args, **kw))
        reloc = {}
        if rr.last is not None:
            rargs, rkw = rr.last
            no_sync(lambda: nodelet_mod.ring_relocalize(*rargs, **rkw))
            ev, busy = device_events(
                lambda: nodelet_mod.ring_relocalize(*rargs, **rkw))
            rms = rr.ms()
            reloc = dict(ring_relocalize_calls=len(rms),
                         ring_relocalize_ms_p50=pctl(np, rms, 50),
                         ring_relocalize_ms_max=max(rms),
                         ring_relocalize_host_ms_p50=pctl(
                             np, [s * 1e3 for s in rr.host_s], 50),
                         ring_relocalize_launches_per_call=ev,
                         ring_relocalize_device_busy_ms=busy)
        tms = tf.ms()
        ok_ms = [m for i, m in frame_ms[5:] if i in set(ids)]
        summaries[name] = dict(
            frames=res.frames_processed, failed=res.frames_failed,
            track_failed_frames=res.track_failed_frames,
            relocalizations=res.relocalizations,
            failed_ids=failed,
            counts_equal_jax=(res.track_failed_frames
                              == ref["track_failed_frames"]
                              and res.relocalizations
                              == ref["relocalizations"]),
            ate_rmse=res.ate_rmse, ate_rmse_sim3=res.ate_rmse_sim3,
            ate_rmse_raw=res.ate_rmse_raw, gt_path_length=res.gt_path_length,
            rpe_trans_rmse=res.rpe_trans_rmse,
            rpe_rot_rmse_deg=res.rpe_rot_rmse_deg,
            rpe30_trans_rmse=res.rpe30_trans_rmse,
            rpe30_rot_rmse_deg=res.rpe30_rot_rmse_deg,
            mean_rmse=res.mean_rmse, mean_precision=res.mean_precision,
            mean_recall=res.mean_recall, final_coverage=res.final_coverage,
            final_abs_rel=res.final_abs_rel, final_delta1=res.final_delta1,
            jax_cpu=ref, diff=diff,
            tracking_ms_per_frame_p50=pctl(np, ok_ms, 50),
            tracking_ms_per_frame_p95=pctl(np, ok_ms, 95),
            main_path_ms_per_frame_p50=pctl(np, ms4, 50),
            main_path_ms_per_frame_p95=pctl(np, ms4, 95),
            track_frame_calls=len(tms),
            track_frame_ms_p50=pctl(np, tms, 50),
            track_frame_ms_p95=pctl(np, tms, 95),
            track_frame_host_ms_p50=pctl(
                np, [s * 1e3 for s in tf.host_s], 50),
            track_frame_launches_per_call=tf_events,
            track_frame_device_busy_ms=tf_busy,
            track_frame_share_of_frame=(
                pctl(np, tms, 50) / pctl(np, ok_ms, 50)),
            no_host_sync=True, launches=launches, work=work, **reloc)
        phase(f"tracking_path_{name}", **summaries[name])
        frame_lists[name] = ok_ms
    return summaries, frame_lists


def track_ba_prefix(node):
    """A tracking run with BA against the JAX run JAX_TRACK_BA_VGA frame
    by frame, over the frames of JAX_TRACK_BA_POSES (to the last frame
    before any of the JAX package's runs of JAX_TRACK_BA_SPREAD parts
    from it) and the solves of JAX_TRACK_BA_COSTS: the largest pose
    difference (quaternion and translation components) and the largest
    relative cost difference."""
    import numpy as np
    got = {int(i): np.concatenate([p.q.detach().cpu().numpy().ravel(),
                                   p.t.detach().cpu().numpy().ravel()])
           for i, _, p in node.trajectory}
    ref = np.asarray(JAX_TRACK_BA_POSES, dtype=np.float64)
    mine = np.stack([got[int(i)] for i in ref[:, 0]])
    n = len(JAX_TRACK_BA_COSTS)
    costs = list(node.ba_costs[:n])
    cost_rel = (max(abs(c / r - 1.0) for c, r in zip(costs,
                                                     JAX_TRACK_BA_COSTS))
                if len(costs) == n else float("inf"))
    return {"last_frame": int(ref[-1, 0]),
            "pose_diff": float(np.abs(mine - ref[:, 1:]).max()),
            "solves": n, "costs": costs, "cost_rel_diff": cost_rel}


def outside_spread(vals):
    """The metrics of vals (the keys of JAX_TRACK_BA_SPREAD) that lie
    outside phase 8's bands about JAX_TRACK_BA_SPREAD, each with its
    value and the spread: rmse relative to the spread's nearer end
    (JAX_BAND), recall and coverage absolute (JAX_BAND), ATE 25 % of the
    nearer end (at least 1e-3 m), the number of solves inside it."""
    out = {}
    for k, v in vals.items():
        lo, hi = JAX_TRACK_BA_SPREAD[k]
        end = min(max(v, lo), hi)
        if k == "ba_solves":
            band = 0
        elif k == "idepth_rmse":
            band = JAX_BAND[k] * end
        elif k == "ate_rmse":
            band = max(0.25 * end, 1e-3)
        else:
            band = JAX_BAND[k]
        if abs(v - end) > band:
            out[k] = (v, lo, hi)
    return out


def tracking_ba_path(seq, ms4, ms8, params, cam, dev, out):
    """Phase 9: phase 8 (a) with windowed bundle adjustment on every
    poseframe (`ba_refine=True`). ms4 and ms8 are phase 4's and phase 8
    (a)'s per-frame host ms."""
    import numpy as np
    from flame_ros_torch.frontends import nodelet as nodelet_mod
    from flame_ros_torch.frontends import offline_runner
    from flame_ros_torch.frontends.nodelet import FlameNodelet
    from flame_ros_torch.models import ba as ba_mod
    from flame_ros_torch.ops import raster_cuda as rc
    n = len(seq)
    ref = JAX_TRACK_BA_VGA
    node = FlameNodelet(cam, params, pose_source="tracking", ba_refine=True,
                        eval_gt_depth=True, trajectory_cap=0, device=dev)
    frame_ms, refine_ms = {}, {}
    process, refine = node._process, node._ba_refine

    def timed(frame):
        t0 = time.perf_counter()
        process(frame)
        frame_ms[frame.img_id] = (time.perf_counter() - t0) * 1e3

    def timed_refine():
        # Ends in the host read of the solve's poses (a sync).
        t0 = time.perf_counter()
        n_before = len(node.ba_costs)
        refine()
        if len(node.ba_costs) > n_before:
            refine_ms[node.trajectory[-1][0]] = \
                (time.perf_counter() - t0) * 1e3

    node._process, node._ba_refine = timed, timed_refine
    stats = []
    node.on_stats.append(stats.append)
    rc.reset_counters()
    with CallTimer(nodelet_mod, "hybrid_bundle_adjust") as hb, \
            CallTimer(ba_mod, "bundle_adjust_window") as bw, \
            CallTimer(nodelet_mod, "gather_ba_inputs") as gb:
        res = offline_runner.run_offline_tracking(
            offline_runner.synthetic_frames(seq), cam, params,
            out_dir=os.path.join(out, "tracking_ba"), device=dev, node=node)
    launches, work = launch_counts(rc, dev)
    # Per poseframe: valid keyframes, the gauge slot and the points it
    # owns (a solve needs >= 3 keyframes and >= 24 points).
    K = params.engine.max_keyframes
    gathers = [[int((p[:K] > 0.5).sum()), int(p[2 * K]), int(p[2 * K + 1])]
               for p in (g.cpu() for g in gb.outs)]
    # The card's BA against its plain CPU path on the last solve's inputs.
    hargs, hkw = hb.last
    on_card = nodelet_mod.hybrid_bundle_adjust(*hargs, **hkw)
    on_cpu = nodelet_mod.hybrid_bundle_adjust(
        *(a.cpu() for a in hargs), **hkw)
    card_cpu = {k: float((getattr(on_card, k).cpu()
                          - getattr(on_cpu, k)).abs().max())
                for k in ("q", "t", "idepths", "gains", "offsets")}
    card_cpu["final_cost_rel"] = abs(
        float(on_card.final_cost) / float(on_cpu.final_cost) - 1.0)
    card_cpu["n_valid_equal"] = int(on_card.n_valid) == int(on_cpu.n_valid)
    ids = [i for i, _, _ in node.trajectory]
    health = [r["health"] for r in stats if "health" in r]
    assert res.frames_failed == 0 and node.engine.num_failed_frames == 0
    assert res.frames_processed == n and ids == list(range(n)), res
    assert res.track_failed_frames == 0, res
    assert len(health) == n and all(h == 1.0 for h in health)
    assert launches["v4"] >= n, launches
    assert launches["v2"] == 0 and launches["v3"] == 0, launches
    assert work == {"v4": launches["v4"], "v2": 0, "v3": 0}, work
    # Every solve went through the hybrid solver.
    assert len(hb.events) == len(bw.events) == len(node.ba_costs)
    diff, _ = track_bands(res, ref, ("ate_rmse", "idepth_rmse", "recall",
                                     "coverage"))
    prefix = track_ba_prefix(node)
    outside = outside_spread(dict(
        idepth_rmse=res.mean_rmse, recall=res.mean_recall,
        coverage=res.final_coverage, ate_rmse=res.ate_rmse,
        ba_solves=len(node.ba_costs)))
    # The last solve again, standalone: no host sync inside
    # bundle_adjust_window; launches and card-busy ms of a whole
    # hybrid_bundle_adjust call and of its window solve.
    bargs, bkw = bw.last
    no_sync(lambda: ba_mod.bundle_adjust_window(*bargs, **bkw))
    hb_events, hb_busy = device_events(
        lambda: nodelet_mod.hybrid_bundle_adjust(*hargs, **hkw))
    bw_events, bw_busy = device_events(
        lambda: ba_mod.bundle_adjust_window(*bargs, **bkw))
    hms = hb.ms()
    pf_ms = [frame_ms[i] for i in refine_ms]
    share = [refine_ms[i] / frame_ms[i] for i in refine_ms]
    steady = [frame_ms[i] for i in ids[5:]]
    summary = dict(
        frames=res.frames_processed, failed=res.frames_failed,
        track_failed_frames=res.track_failed_frames,
        relocalizations=res.relocalizations, ba_solves=len(node.ba_costs),
        ba_costs=node.ba_costs, ba_poseframes=sorted(refine_ms),
        ba_gathers=gathers, card_vs_cpu_last_solve=card_cpu,
        ate_rmse=res.ate_rmse, ate_rmse_sim3=res.ate_rmse_sim3,
        ate_rmse_raw=res.ate_rmse_raw, gt_path_length=res.gt_path_length,
        rpe_trans_rmse=res.rpe_trans_rmse,
        rpe_rot_rmse_deg=res.rpe_rot_rmse_deg,
        rpe30_trans_rmse=res.rpe30_trans_rmse,
        rpe30_rot_rmse_deg=res.rpe30_rot_rmse_deg,
        mean_rmse=res.mean_rmse, mean_precision=res.mean_precision,
        mean_recall=res.mean_recall, final_coverage=res.final_coverage,
        final_abs_rel=res.final_abs_rel, final_delta1=res.final_delta1,
        jax_cpu=ref, diff=diff, jax_spread=JAX_TRACK_BA_SPREAD,
        outside_jax_spread=outside, to_frame=prefix,
        hybrid_ba_ms_p50=pctl(np, hms, 50), hybrid_ba_ms_max=max(hms),
        hybrid_ba_host_ms_p50=pctl(np, [x * 1e3 for x in hb.host_s], 50),
        hybrid_ba_launches_per_call=hb_events,
        hybrid_ba_device_busy_ms=hb_busy,
        ba_window_ms_p50=pctl(np, bw.ms(), 50),
        ba_window_launches_per_call=bw_events,
        ba_window_device_busy_ms=bw_busy,
        ba_refine_ms_p50=pctl(np, list(refine_ms.values()), 50),
        ba_refine_ms_max=max(refine_ms.values()),
        ba_poseframe_ms_p50=pctl(np, pf_ms, 50),
        ba_refine_share_of_poseframe_p50=pctl(np, share, 50),
        ba_refine_share_of_poseframe_min=min(share),
        ba_window_no_host_sync=True,
        tracking_ba_ms_per_frame_p50=pctl(np, steady, 50),
        tracking_ba_ms_per_frame_p95=pctl(np, steady, 95),
        tracking_ms_per_frame_p50=pctl(np, ms8, 50),
        tracking_ms_per_frame_p95=pctl(np, ms8, 95),
        main_path_ms_per_frame_p50=pctl(np, ms4, 50),
        main_path_ms_per_frame_p95=pctl(np, ms4, 95),
        launches=launches, work=work)
    checks = {
        "poses_and_solves_as_jax_to_frame": (
            prefix["pose_diff"] <= TRACK_BA_POSE_TOL
            and prefix["cost_rel_diff"] <= TRACK_BA_COST_TOL),
        "within_jax_spread": not outside,
        "card_equals_cpu_path": (card_cpu["n_valid_equal"]
                                 and max(card_cpu["q"], card_cpu["t"]) <= 1e-4
                                 and card_cpu["final_cost_rel"] <= 1e-3)}
    phase("tracking_ba_path", checks=checks, **summary)
    failed = [k for k, v in checks.items() if not v]
    assert not failed, failed
    return summary, node, stats


class BatchedRecorder:
    """Wraps `rasterize_tri_ids_v4_batched` of the raster_cuda module: on
    the calls made while `keep` is set, the inputs and output are kept
    (copies), so that the runner's own raster can be recomputed. The
    wrapper's counters stay the wrapped function's."""

    def __init__(self, rc):
        self.rc, self.fn, self.keep, self.calls = rc, \
            rc.rasterize_tri_ids_v4_batched, False, []

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, v):
        self.fn.launches = v

    @property
    def images(self):
        return self.fn.images

    @images.setter
    def images(self, v):
        self.fn.images = v

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        if self.keep:
            self.calls.append(([a.clone() for a in args], out.clone()))
        return out

    def __enter__(self):
        self.rc.rasterize_tri_ids_v4_batched = self
        return self

    def __exit__(self, *exc):
        self.rc.rasterize_tri_ids_v4_batched = self.fn


def vmap_fallback_errors():
    """A context in which an op without a batching rule under
    torch.func.vmap (torch's "performance drop" warning) raises."""
    import contextlib
    import warnings
    import torch

    @contextlib.contextmanager
    def ctx():
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            torch._C._functorch._set_vmap_fallback_warning_enabled(True)
            try:
                yield
            finally:
                torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    return ctx()


def bare_batched_launch(rc, args, H, W, rt=2):
    """One launch of the batched v4 kernel alone, its inputs prepared
    once; fn.slab_bytes the bytes of its inputs."""
    import torch
    lib = rc._get_lib()
    C, lo_pos, hi_pos, counts = rc.v4_setup_batched(
        *args, height=H, row_tile=rt, long_thresh=48.0)
    S, T = args[1].shape[:2]
    out = torch.empty((S, H * W), dtype=torch.int32, device=args[0].device)
    work = torch.zeros(len(rc.WORK_SLOTS), dtype=torch.int32,
                       device=args[0].device)
    stream = torch.cuda.current_stream().cuda_stream

    def fn():
        lib.raster_v4_batched_launch(
            C.data_ptr(), S, T, lo_pos.data_ptr(), hi_pos.data_ptr(),
            counts.data_ptr(), out.data_ptr(), H, W, rt, work.data_ptr(),
            stream)
    fn.keep = (C, lo_pos, hi_pos, counts)
    fn.slab_bytes = sum(t.numel() * t.element_size() for t in fn.keep)
    return fn


def ms_frames(seq_np, i, S, SE3):
    """Frame i of the runner's S streams: stream k gets frame max(i - k,
    0) (tests/test_multi_stream.py's stream 1 one frame behind)."""
    ids = [max(i - k, 0) for k in range(S)]
    imgs, depths, q, t, ts = seq_np
    return ([(float(ts[j]), j, SE3.from_quat_trans(q[j], t[j]), imgs[j])
             for j in ids], depths[ids])


def truth_summary(recs):
    """Mean rmse and recall over a stream's per-frame stats, and its last
    frame's coverage (the stats' raster coverage)."""
    import numpy as np
    from flame_ros_torch.eval.metrics import TruthStats
    ts = [TruthStats.from_record(r) for r in recs]
    return {"mean_rmse": float(np.nanmean([t.rmse for t in ts])),
            "mean_recall": float(np.nanmean([t.recall for t in ts])),
            "final_coverage": float(recs[-1]["coverage"])}


def multi_stream_path(seq, ms4, params, cam, dev, out):
    """Phase 10 over phase 4's sequence `seq` (ms4: phase 4's steady host
    ms per frame): (a) correctness at S = 4, (b) throughput at S = 1, 2, 4,
    8, (c) checkpoint and getters. Returns the batched kernel's numbers
    for the kernels line."""
    import numpy as np
    import torch
    from flame_ros_torch.geometry.se3 import SE3
    from flame_ros_torch.models.engine import EngineState, Flame, state_leaves
    from flame_ros_torch.ops import raster as raster_ops
    from flame_ros_torch.ops.epipolar import FeatureFilterState
    from flame_ros_torch.ops import raster_cuda as rc
    from flame_ros_torch.parallel import multi_stream as ms_mod
    from flame_ros_torch.parallel.multi_stream import MultiStreamRunner
    H, W = cam.height, cam.width
    n = len(seq)
    imgs = torch.clamp(seq.images, 0, 255).to(torch.uint8).cpu().numpy()
    seq_np = (imgs, seq.depths.cpu().numpy(), seq.poses.q.cpu().numpy(),
              seq.poses.t.cpu().numpy(), np.asarray(seq.timestamps))
    pf_every = params.input.poseframe_subsample_factor
    checked = (7, 12, 17, 30, 36, 47, 57)   # 12, 30 and 36 are poseframes
    S = 4
    leaf_names = ([f"feat.{k}" for k in FeatureFilterState._fields]
                  + list(EngineState._fields[1:]))

    # (a) correctness, S = 4, synchronous triangulation -----------------
    ckpt_path = os.path.join(out, "multi_stream_ckpt")
    with vmap_fallback_errors():
        runner = MultiStreamRunner(cam, S, params=params, device=dev)
        recs = [[] for _ in range(S)]
        snaps = {}
        rc.reset_counters()
        with BatchedRecorder(rc) as rec:
            for i in range(n):
                frames, gts = ms_frames(seq_np, i, S, SE3)
                rec.keep = i in checked
                assert runner.update(frames, gt_depths=gts)
                for k, r in enumerate(runner.flush_stats()):
                    recs[k].append(r)
                if i + 1 in (6, n):
                    snaps[i + 1] = [t.clone() for t in
                                    state_leaves(runner.states)]
                if i + 1 == 30:
                    runner.save_checkpoint(ckpt_path)
        launches = {"v4": rc.rasterize_tri_ids_v4.launches,
                    "v2": rc.rasterize_tri_ids_v2.launches,
                    "v3": rc.rasterize_tri_ids_v3.launches,
                    "v4_batched": rc.rasterize_tri_ids_v4_batched.launches,
                    "v4_batched_images":
                        rc.rasterize_tri_ids_v4_batched.images}
        work = dict(zip(rc.WORK_SLOTS, rc.work_counters(dev).tolist()))
        assert launches == {"v4": 0, "v2": 0, "v3": 0, "v4_batched": n,
                            "v4_batched_images": n * S}, launches
        assert work == {"v4": 0, "v2": 0, "v3": 0, "v4_batched": n,
                        "v4_batched_images": n * S}, work
        # The batched kernel on the runner's own inputs against its plain
        # version, and each image against the plain formulation (v4's
        # evaluation-order split allowed, order_split).
        assert len(rec.calls) == len(checked), len(rec.calls)
        split, max_err = [], 0
        for (args, got), i in zip(rec.calls, checked):
            want = rc.rasterize_tri_ids_v4_batched_ref(*args, height=H,
                                                       width=W)
            max_err = max(max_err, int((got.long() - want.long()).abs()
                                       .max()))
            if not torch.equal(got, want):
                raise AssertionError(f"frame {i}: batched v4 != plain")
            for k in range(S):
                n_px, explained = order_split(
                    torch, rc, args[0][k], args[1][k], got[k],
                    raster_ops.rasterize_tri_ids(
                        args[0][k], args[1][k], args[2][k], height=H,
                        width=W))
                assert explained, (i, k)
                split.append(n_px)
        kernel_args = rec.calls[-1][0]
        # No host sync in batched_full_step (a frame and a poseframe) on
        # inputs already on the card.
        ids = [max(n - 1 - k, 0) for k in range(S)]
        b_imgs = torch.from_numpy(imgs[ids]).to(dev)
        b_gt = torch.from_numpy(seq_np[1][ids]).to(dev)
        b_meta = torch.zeros((S, 10), dtype=torch.float32, device=dev)
        b_meta[:, :4] = seq.poses.q[ids].to(dev)
        b_meta[:, 4:7] = seq.poses.t[ids].to(dev)
        b_meta[:, 7] = torch.tensor(ids, dtype=torch.float32, device=dev)
        for is_pf in (False, True):
            no_sync(lambda: ms_mod.batched_full_step(
                runner.states, b_imgs, b_meta, b_gt, cam=cam,
                params=runner.params, is_pf=is_pf, kf_slot=0))

    # Each stream against a single engine fed its frames with the same
    # poseframe schedule.
    singles = [Flame(W, H, cam=cam, params=params, device=dev)
               for _ in range(S)]
    srecs = [[] for _ in range(S)]
    ssnaps = {}
    for i in range(n):
        frames, gts = ms_frames(seq_np, i, S, SE3)
        for k, eng in enumerate(singles):
            assert eng.update(*frames[k], is_poseframe=i % pf_every == 0,
                              gt_depth=gts[k])
            srecs[k].append(eng.flush_stats())
        if i + 1 in (6, n):
            ssnaps[i + 1] = [state_leaves(e.state) for e in singles]
    bit_equal = {f"frame_{f}": {
        f"stream_{k}": [name for j, name in enumerate(leaf_names)
                        if torch.equal(snaps[f][j][k], ssnaps[f][k][j])]
        for k in range(S)} for f in (6, n)}
    summ = [truth_summary(r) for r in recs]
    ssumm = [truth_summary(r) for r in srecs]
    bands = []
    for k in range(S):
        a, b = summ[k], ssumm[k]
        d = {"rmse_rel": abs(a["mean_rmse"] - b["mean_rmse"])
             / b["mean_rmse"],
             "recall": abs(a["mean_recall"] - b["mean_recall"]),
             "coverage": abs(a["final_coverage"] - b["final_coverage"])}
        assert d["rmse_rel"] <= 0.01 and d["recall"] <= 0.01 \
            and d["coverage"] <= 0.01, (k, a, b, d)
        bands.append(d)
    stats_equal = [sum(r1 == r2 for r1, r2 in zip(recs[k], srecs[k]))
                   for k in range(S)]
    assert all(r["health"] == 1.0 for rs in recs for r in rs)
    phase("multi_stream_correctness", streams=S, frames=n,
          checked_frames=list(checked), kernel_equal_plain=True,
          order_split_px=split, launches=launches, work=work,
          no_host_sync=True, vmap_fallback="error",
          per_stream=summ, single_engines=ssumm, band_diff=bands,
          frames_with_equal_stats=stats_equal, bit_equal_leaves=bit_equal)

    # (c) checkpoint at frame 30 and the getters -------------------------
    with vmap_fallback_errors():
        fresh = MultiStreamRunner(cam, S, params=params, device=dev)
        fresh.load_checkpoint(ckpt_path)
        for i in range(30, n):
            assert fresh.update(*ms_frames(seq_np, i, S, SE3))
    differ = [leaf_names[j] for j, (a, b) in
              enumerate(zip(state_leaves(fresh.states), snaps[n]))
              if not torch.equal(a, b)]
    assert not differ, f"resumed runner != uninterrupted in {differ}"
    meshes = runner.get_meshes()
    maps = runner.get_idepth_maps()
    assert maps.shape == (S, H, W), maps.shape
    assert len(meshes) == S and all(len(m[2]) > 0 and np.isfinite(m[1]).all()
                                    for m in meshes)
    runner.shutdown()
    fresh.shutdown()
    phase("multi_stream_checkpoint", resumed_at=30, frames=n,
          equal_leaves=len(leaf_names),
          mesh_tris=[len(m[2]) for m in meshes],
          idepth_maps_shape=list(maps.shape),
          coverage=[float(np.isfinite(m).mean()) for m in maps])

    # (b) throughput, S = 1, 2, 4, 8, deferred triangulation -------------
    def timed_updates(r):
        """Host ms of each update over the n frames, to its stats read
        (one device-to-host copy: a sync)."""
        t_upd = []
        for i in range(n):
            frames, _ = ms_frames(seq_np, i, r.S, SE3)
            t0 = time.perf_counter()
            r.update(frames)
            r.flush_stats()
            t_upd.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(t_upd[5:])

    rows = {}
    for s_n in (1, 2, 4, 8):
        # Synchronous triangulation first: its ordinary frames run with
        # no Delaunay thread beside them (the dispatch cost alone).
        r = MultiStreamRunner(cam, s_n, params=params, device=dev)
        with vmap_fallback_errors():
            sync_ms = timed_updates(r)
        r.shutdown()
        r = MultiStreamRunner(cam, s_n, params=params, device=dev,
                              deferred_triangulation=True)
        with vmap_fallback_errors():
            steady = timed_updates(r)
            # Launches and card-busy ms of one update (profiler): frame
            # 61 is a poseframe, 62 an ordinary frame.
            prof = {}
            for name in ("poseframe", "frame"):
                frames, _ = ms_frames(seq_np, n - 1, s_n, SE3)
                prof[name] = device_events(lambda: r.update(frames))
            r.drain_topologies()
        r.shutdown()
        ordinary = [k - 5 for k in range(5, n) if k % pf_every]
        rows[s_n] = {
            "ms_per_update_p50": float(np.percentile(steady, 50)),
            "ms_per_update_p95": float(np.percentile(steady, 95)),
            "aggregate_frames_per_s": float(s_n * len(steady)
                                            / (steady.sum() / 1e3)),
            "launches_per_update": prof["frame"][0],
            "busy_ms_per_update": prof["frame"][1],
            "launches_per_poseframe": prof["poseframe"][0],
            "busy_ms_per_poseframe": prof["poseframe"][1],
            "delaunay_round_host_ms_p50": float(
                np.percentile(r.tri_round_s, 50) * 1e3),
            "topo_dropped": r.topo_dropped,
            "sync_ms_per_update_p50": float(np.percentile(sync_ms, 50)),
            "sync_ms_per_ordinary_frame_p50": float(np.percentile(
                sync_ms[ordinary], 50)),
            "deferred_ms_per_ordinary_frame_p50": float(np.percentile(
                steady[ordinary], 50))}
        phase("multi_stream_throughput", streams=s_n, **rows[s_n],
              phase4_ms_per_frame_p50=float(np.percentile(ms4, 50)))
    ratio = rows[8]["launches_per_update"] / rows[1]["launches_per_update"]
    assert ratio <= 1.25, f"launches grow with streams: {ratio}"

    # The batched kernel on the runner's inputs (frame 57) at S = 1, 4, 8.
    times = {}
    for s_n in (1, 4, 8):
        args = [torch.cat([a] * 2)[:s_n] for a in kernel_args]
        kern = rc.rasterize_tri_ids_v4_batched
        assert torch.equal(kern(*args, height=H, width=W),
                           rc.rasterize_tri_ids_v4_batched_ref(
                               *args, height=H, width=W))
        bare = bare_batched_launch(rc, args, H, W)
        pairs = sum(bbox_pairs(torch, args[0][k], args[1][k], args[2][k],
                               H, W) for k in range(s_n))
        b_ops = pairs * INSTR_PER_TEST["v4"] / F32_INSTR_RATE * 1e3
        b_bytes = (bare.slab_bytes + s_n * H * W * 4) / PEAK_BYTES * 1e3
        times[s_n] = dict(
            ms=cuda_median_ms(lambda: kern(*args, height=H, width=W)),
            kernel_only_ms=cuda_median_ms(bare),
            kernel_device_ms=device_ms(bare),
            plain_ms=cuda_median_ms(
                lambda: rc.rasterize_tri_ids_v4_batched_ref(
                    *args, height=H, width=W), reps=5, warmup=1),
            bound_ms=max(b_ops, b_bytes),
            bound_by="operations" if b_ops >= b_bytes else "bytes",
            bbox_pairs=pairs)
    phase("multi_stream_kernel", **{f"S{k}": v for k, v in times.items()})
    return dict(times[S], launches=launches["v4_batched"], max_err=max_err)


def batched_counts(rc, dev):
    """The batched v4 wrapper's launches and images, the device work
    counters, and the other kernels' wrapper launches."""
    work = dict(zip(rc.WORK_SLOTS, rc.work_counters(dev).tolist()))
    return {"v4_batched": rc.rasterize_tri_ids_v4_batched.launches,
            "v4_batched_images": rc.rasterize_tri_ids_v4_batched.images,
            "work_v4_batched": work["v4_batched"],
            "work_v4_batched_images": work["v4_batched_images"],
            "v4": rc.rasterize_tri_ids_v4.launches,
            "v2": rc.rasterize_tri_ids_v2.launches,
            "v3": rc.rasterize_tri_ids_v3.launches}


def run_workers(dev, out):
    """Phase 12 (d): `parallel/dist_e2e.py` as subprocesses, two ranks
    (gloo) sharing the card: the uninterrupted run (frame-7 shards, then
    --bench), the single-process baseline, --spatial, and a run whose
    rank 1 is killed after its shards are on disk, restarted from them.
    Every process is stopped before this returns."""
    import socket
    module = "flame_ros_torch.parallel.dist_e2e"
    env = dict(os.environ, PYTHONPATH=REPO)

    def port():
        sk = socket.socket()
        sk.bind(("127.0.0.1", 0))
        p = sk.getsockname()[1]
        sk.close()
        return str(p)

    def start(*args):
        return subprocess.Popen([sys.executable, "-m", module, *args],
                                cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    on = ["--device", "cpu"] if dev.type == "cpu" else []

    def pair(*extra):
        pt = port()
        return [start(str(r), "2", pt, "13", *on, *extra) for r in (0, 1)]

    def finish(procs):
        outs = []
        for p in procs:
            o, _ = p.communicate(timeout=400)
            outs.append(o)
        return outs

    def payloads(text, marker="DIST_E2E_OK"):
        got = {}
        for line in text.splitlines():
            if line.startswith(marker + " "):
                got[int(line.split("stream=")[1].split()[0])] = \
                    line.split("frames=", 1)[1]
        return got

    ck_a = os.path.join(out, "dist_ckpt_a")
    ck_b = os.path.join(out, "dist_ckpt_b")
    for f in os.listdir(out):
        if f.startswith("dist_ckpt_"):
            os.remove(os.path.join(out, f))
    t0 = time.perf_counter()
    procs = []
    try:
        a = pair(f"--ckpt={ck_a}", "--ckpt-at=7", "--bench")
        single = [start("0", "2", "0", "13", *on, "--single", "--bench")]
        sp = pair("--spatial")
        b = pair(f"--ckpt={ck_b}", "--ckpt-at=7", "--pause-after-save=300")
        procs = a + single + sp + b
        shards = [f"{ck_b}.p{r}.npz" for r in (0, 1)]
        deadline = time.time() + 300
        while not all(os.path.exists(f) for f in shards):
            if any(p.poll() is not None for p in b):
                raise AssertionError("a killed-run rank exited early: "
                                     + b[0].communicate()[0][-2000:])
            assert time.time() < deadline, "no checkpoint shards"
            time.sleep(0.2)
        b[1].kill()
        b[1].wait(timeout=60)
        b[0].kill()
        b[0].wait(timeout=60)
        killed_rc = [b[0].returncode, b[1].returncode]
        # The restart runs beside the runs still going.
        c = pair(f"--ckpt={ck_b}", "--ckpt-at=7", "--ckpt-load")
        procs += c
        outs_a, outs_s, outs_sp = finish(a), finish(single), finish(sp)
        outs_c = finish(c)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    codes = {"uninterrupted": [p.returncode for p in a],
             "single": [single[0].returncode],
             "spatial": [p.returncode for p in sp],
             "restarted": [p.returncode for p in c]}
    for name, rcs in codes.items():
        if any(rcs):
            text = {"uninterrupted": outs_a, "single": outs_s,
                    "spatial": outs_sp, "restarted": outs_c}[name]
            raise AssertionError(f"{name} worker failed {rcs}: "
                                 + " | ".join(t[-1500:] for t in text))
    ref = payloads(outs_s[0])
    got_a = {k: v for o in outs_a for k, v in payloads(o).items()}
    got_c = {k: v for o in outs_c for k, v in payloads(o).items()}
    got_sp = {k: v for o in outs_sp
              for k, v in payloads(o, "DIST_E2E_SPATIAL_OK").items()}
    def fps_of(outs):
        return [float(line.split("fps=")[1]) for o in outs
                for line in o.splitlines() if line.startswith("DIST_E2E_FPS")]

    fps, fps_single = fps_of(outs_a), fps_of(outs_s)
    assert sorted(ref) == [0, 1] and got_a == ref, (got_a, ref)
    assert got_c == got_a, (got_c, got_a)
    assert sorted(got_sp) == [0, 1], outs_sp
    assert all("CKPT_LOADED" in o for o in outs_c)
    assert all(rc_ != 0 for rc_ in killed_rc), killed_rc
    return dict(single_payload=ref, two_process_payload=got_a,
                restarted_payload=got_c, spatial_payload=got_sp,
                killed_returncodes=killed_rc,
                bench_frames_per_s_per_rank=fps,
                bench_aggregate_frames_per_s=sum(fps),
                single_process_bench_frames_per_s=fps_single,
                seconds=time.perf_counter() - t0, device=str(dev))


def multi_device_path(seq, params, cam, dev, out, node9, stats9, smi,
                      ba_points=16384, nodelet_frames=20):
    """Phase 12: the multi-device paths on one card. (a) stream groups,
    (b) the spatial NLTGV2 partition, (c) the point-sharded BA, (d) two
    processes sharing the card. node9 and stats9: phase 9's nodelet and
    its per-frame stats."""
    import warnings
    import numpy as np
    import torch
    from flame_ros_torch.frontends import nodelet as nodelet_mod
    from flame_ros_torch.frontends import offline_runner
    from flame_ros_torch.frontends.nodelet import FlameNodelet
    from flame_ros_torch.geometry.se3 import SE3
    from flame_ros_torch.models import ba as ba_mod
    from flame_ros_torch.models.engine import (DEVICE_STATS_KEYS,
                                               state_from_leaves, state_leaves)
    from flame_ros_torch.ops import nltgv2 as reg_ops
    from flame_ros_torch.ops import raster_cuda as rc
    from flame_ros_torch.parallel import multi_stream as ms_mod
    from flame_ros_torch.parallel import spatial_pd
    from flame_ros_torch.parallel.multi_stream import MultiStreamRunner
    t_phase = time.perf_counter()
    imgs = torch.clamp(seq.images, 0, 255).to(torch.uint8).cpu().numpy()
    seq_np = (imgs, seq.depths.cpu().numpy(), seq.poses.q.cpu().numpy(),
              seq.poses.t.cpu().numpy(), np.asarray(seq.timestamps))
    n = 13          # poseframes 0, 6, 12: three topology installs
    per = n if dev.type == "cuda" else 0    # batched launches per group

    def drive(r, S, save=None, lo=0):
        """Host ms of each update to its stats read, and the stats, over
        frames lo..n-1; save=(frame, path) writes a checkpoint before that
        frame, outside its time."""
        t_upd, rows = [], []
        for i in range(lo, n):
            frames, _ = ms_frames(seq_np, i, S, SE3)
            if save is not None and i == save[0]:
                r.save_checkpoint(save[1])
            t0 = time.perf_counter()
            r.update(frames)
            rows.append(r.flush_stats())
            t_upd.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(t_upd), rows

    prof_s = []

    def profiled(fn):
        t0 = time.perf_counter()
        out_ = device_events(fn)
        prof_s.append(time.perf_counter() - t0)
        return out_

    def timing(ms_arr, S, r):
        """ms per update p50/p95 and aggregate frames/s over the steady
        frames (from the fourth), and launches / card-busy ms of one more
        update (an ordinary frame) by the profiler."""
        steady = ms_arr[3:]
        frames, _ = ms_frames(seq_np, n, S, SE3)
        ev, busy = profiled(lambda: r.update(frames))
        return {"ms_per_update_p50": float(np.percentile(steady, 50)),
                "ms_per_update_p95": float(np.percentile(steady, 95)),
                "aggregate_frames_per_s": float(
                    S * len(steady) / (steady.sum() / 1e3)),
                "launches_per_update": ev, "busy_ms_per_update": busy}

    def device_inputs(S):
        ids = [max(n - 1 - k, 0) for k in range(S)]
        meta = torch.zeros((S, 10), dtype=torch.float32, device=dev)
        meta[:, :4] = seq.poses.q[ids].to(dev)
        meta[:, 4:7] = seq.poses.t[ids].to(dev)
        meta[:, 7] = torch.tensor(ids, dtype=torch.float32, device=dev)
        return torch.from_numpy(imgs[ids]).to(dev), meta

    # (a) stream groups ----------------------------------------------------
    section = {}
    t_sec = time.perf_counter()
    for name, S, G in (("S4_2groups", 4, 2), ("S8_4groups", 8, 4)):
        plain = MultiStreamRunner(cam, S, params=params, device=dev)
        with vmap_fallback_errors():
            p_ms, p_rows = drive(plain, S)
        grp = MultiStreamRunner(cam, S, params=params, mesh=[dev] * G)
        rc.reset_counters()
        with vmap_fallback_errors():
            g_ms, g_rows = drive(grp, S)
        counts = batched_counts(rc, dev)
        differ = [j for j, (a, b) in enumerate(zip(
            state_leaves(grp.states), state_leaves(plain.states)))
            if not torch.equal(a, b)]
        assert not differ, f"{name}: leaves {differ} differ from plain"
        stats_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1.0)
                        for ra, rb in zip(g_rows, p_rows)
                        for a, b in zip(ra, rb) for k in a)
        assert stats_rel <= 1e-5, f"{name}: stats differ from plain"
        launched = list(grp.group_launches)
        assert launched == [per] * G, launched
        assert counts == {"v4_batched": per * G,
                          "v4_batched_images": per * S,
                          "work_v4_batched": per * G,
                          "work_v4_batched_images": per * S, "v4": 0,
                          "v2": 0, "v3": 0}, counts
        b_imgs, b_meta = device_inputs(S // G)
        for is_pf in (False, True):
            no_sync(lambda: ms_mod.batched_full_step(
                grp._gstates[0], b_imgs, b_meta, None, cam=cam,
                params=grp.params, is_pf=is_pf, kf_slot=0))
        phase("multi_device_streams", layout=name, streams=S, groups=G,
              frames=n, card=smi, leaves_equal_plain=True,
              stats_equal_plain=g_rows == p_rows,
              stats_max_rel_diff=stats_rel, no_host_sync=True,
              launches_per_group=launched, counts=counts,
              groups_timing=timing(g_ms, S, grp),
              plain_timing=timing(p_ms, S, plain))
        grp.shutdown()
        plain.shutdown()

    # (b) the spatial partition, S = 2 -------------------------------------
    section["a"], t_sec = time.perf_counter() - t_sec, time.perf_counter()
    S = 2
    save_at = 8

    def spatial_resume(spr, sp_params, ckpt, P):
        """A fresh spatial runner loads spr's checkpoint (written before
        frame save_at) and runs on to frame n. At load every stream is
        re-triangulated at watermark _max_frame_id, as in the JAX
        package: the installed edges must equal a fresh host Delaunay of
        the restored vertex positions and graph membership, and the
        watermark _max_frame_id. Then no host sync in
        batched_full_step_spatial on the load's partitions."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r = MultiStreamRunner(cam, S, params=sp_params,
                                  mesh=[[dev] * P])
        t0 = time.perf_counter()
        r.load_checkpoint(ckpt)
        load_ms = (time.perf_counter() - t0) * 1e3
        wm = r._max_frame_id
        assert wm == save_at - 1, wm
        st = r.states
        builder = ms_mod._HostTopologyBuilder(sp_params)
        uv = st.vtx_uv.cpu().numpy()
        elig = st.vtx_in_graph.cpu().numpy()
        edges, ev = st.edges.cpu().numpy(), st.edge_valid.cpu().numpy()
        for k in range(S):
            fe, fv = builder.packed_edges(builder.build(uv[k], elig[k], wm))
            assert np.array_equal(edges[k], fe), f"P={P} stream {k}: edges"
            assert np.array_equal(ev[k], fv), f"P={P} stream {k}: valid"
        wms = st.topo_frame_id.cpu().tolist()
        assert wms == [wm] * S, wms
        assert all(p is not None for p in r.parts)
        r_ms, _ = drive(r, S, lo=save_at)
        b_imgs, b_meta = device_inputs(S)
        no_sync(lambda: ms_mod.batched_full_step_spatial(
            r._gstates[0], r.parts[0], b_imgs, b_meta, None, cam=cam,
            params=r.params, is_pf=False, kf_slot=0))
        a_st, b_st = r.states, spr.states
        ev_b = a_st.edge_valid
        ra, rb = r.get_idepth_maps(), spr.get_idepth_maps()
        gap = {"map_finite_agreement": float(
            (np.isfinite(ra) == np.isfinite(rb)).mean()),
            "edge_q_max_abs": float(
            (a_st.edge_q - b_st.edge_q)[ev_b].abs().max()),
            "vtx_x_max_abs": float(
                (a_st.vtx_x - b_st.vtx_x)[a_st.vtx_in_graph].abs().max())}
        r.shutdown()
        return {"saved_before_frame": save_at, "watermark": wm,
                "edges_equal_fresh_delaunay": True, "load_ms": load_ms,
                "continued_frames": len(r_ms), "no_host_sync": True,
                "diff_vs_uninterrupted": gap}

    plain = MultiStreamRunner(cam, S, params=params, device=dev)
    with EventTimer(reg_ops, "pd_iterate") as pt:
        p_ms, p_rows = drive(plain, S)
    plain_sweep = pt.ms()
    p_st = [t.clone() for t in state_leaves(plain.states)]
    p_maps = plain.get_idepth_maps()
    p_time = timing(p_ms, S, plain)      # one more update: after the copies
    for P in (2, 4):
        sp_params = dataclasses.replace(params, engine=dataclasses.replace(
            params.engine, spatial_parts=P))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            spr = MultiStreamRunner(cam, S, params=sp_params,
                                    mesh=[[dev] * P])
        rc.reset_counters()
        ckpt = os.path.join(out, f"spatial_P{P}_ckpt")
        with EventTimer(spatial_pd, "pd_iterate_spatial_batched") as st_:
            s_ms, s_rows = drive(spr, S, save=(save_at, ckpt))
        counts = batched_counts(rc, dev)
        launched = list(spr.group_launches)
        assert all(p is not None for p in spr.parts)
        assert len(st_.events) >= n - 1, len(st_.events)
        ma, mb = spr.get_idepth_maps(), p_maps
        both = np.isfinite(ma) & np.isfinite(mb)
        agree = float((np.isfinite(ma) == np.isfinite(mb)).mean())
        a_st, b_st = spr.states, state_from_leaves(p_st)
        g = a_st.vtx_in_graph
        ev = a_st.edge_valid
        diff = {
            "finite_agreement": agree,
            "map_max_abs": float(np.abs(ma - mb)[both].max()),
            "vtx_in_graph_equal": bool(torch.equal(g, b_st.vtx_in_graph)),
            "vtx_x_max_abs": float((a_st.vtx_x - b_st.vtx_x)[g].abs().max()),
            "edge_q_max_abs": float(
                (a_st.edge_q - b_st.edge_q)[ev].abs().max()),
            "stats_rel": max(
                abs(r1[k] - r2[k]) / max(abs(r2[k]), 1.0)
                for r1, r2 in zip(s_rows[-1], p_rows[-1])
                for k in ("coverage", "num_tris", "nltgv2_total_data_cost")),
            "leaves_bit_equal": all(torch.equal(x, y) for x, y in zip(
                state_leaves(a_st), state_leaves(b_st)))}
        ok = (agree > 0.999 and diff["map_max_abs"] < 1e-4
              and diff["vtx_in_graph_equal"] and diff["vtx_x_max_abs"] <= 1e-5
              and diff["edge_q_max_abs"] <= 1e-5 and diff["stats_rel"] <= 1e-3)
        b_imgs, b_meta = device_inputs(S)
        no_sync(lambda: ms_mod.batched_full_step_spatial(
            spr._gstates[0], spr.parts[0], b_imgs, b_meta, None, cam=cam,
            params=spr.params, is_pf=False, kf_slot=0))
        sweep = st_.ms()
        resume = spatial_resume(spr, sp_params, ckpt, P)
        phase("multi_device_spatial", streams=S, parts=P, frames=n,
              card=smi, diff_vs_plain=diff, within_bounds=ok,
              no_host_sync=True, counts=counts, resume=resume,
              launches_per_group=launched,
              sweep_ms_p50=float(np.percentile(sweep, 50)),
              plain_sweep_ms_p50=float(np.percentile(plain_sweep, 50)),
              spatial_timing=timing(s_ms, S, spr), plain_timing=p_time)
        assert ok, diff
        assert launched == [per] and counts["v4_batched"] == per, \
            (launched, counts)
        spr.shutdown()
    plain.shutdown()

    # (c) the point-sharded BA at a dense budget ---------------------------
    section["b"], t_sec = time.perf_counter() - t_sec, time.perf_counter()
    st = node9.engine.state
    ptp = params.pose_tracking
    # The engine holds fewer feature slots than the budget: the gauge's
    # features fill the first lanes, the rest are point_valid=False pads
    # (as a dense configuration's unfilled budget is).
    Pb = ba_points
    Pg = min(Pb, int(st.feat.valid.shape[0]))
    packed = ba_mod.gather_ba_inputs(
        st.kf_valid, st.kf_ids, st.feat.valid, st.feat.kf_idx,
        st.feat.uv_ref, st.feat.mu, budget=Pg, anchor=ptp.ba_anchor)
    buf = packed.cpu().numpy()
    K = int(st.kf_valid.shape[0])
    ref_slot, n_sel = int(buf[2 * K]), int(buf[2 * K + 1])
    off = 2 * K + 2
    uv = torch.zeros((Pb, 2), dtype=torch.float32, device=dev)
    uv[:Pg] = packed[off:off + 2 * Pg].reshape(Pg, 2)
    d0 = torch.full((Pb,), 0.5, dtype=torch.float32, device=dev)
    d0[:Pg] = packed[off + 2 * Pg:off + 3 * Pg]
    pv = torch.zeros((Pb,), dtype=torch.bool, device=dev)
    pv[:Pg] = packed[off + 3 * Pg:off + 4 * Pg] > 0.5

    def roll(a):
        return torch.roll(a, -ref_slot, 0)

    win = (roll(st.kf_pyrs), roll(st.kf_q), roll(st.kf_t), roll(st.kf_valid),
           uv, d0, pv)
    kw = dict(cam=cam, num_iters=4, coarse_iters=2, level=1)

    def timed(fn):
        """One call between two CUDA events (its result is the one
        checked), then one under the profiler."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out_ = fn()
        b.record()
        torch.cuda.synchronize()
        ev_, busy_ = profiled(fn)
        return out_, {"ms": a.elapsed_time(b), "launches": ev_,
                      "busy_ms": busy_}

    ref, t_ref = timed(lambda: ba_mod.hybrid_bundle_adjust(*win, rounds=1,
                                                           **kw))
    ba_rows = {"unsharded": t_ref}
    ba_ok = True
    for nsh in (2, 4):
        res, t_sh = timed(lambda: ba_mod.hybrid_bundle_adjust_sharded(
            [dev] * nsh, *win, **kw))
        d = {k: float((getattr(res, k) - getattr(ref, k)).abs().max())
             for k in ("q", "t", "idepths", "gains")}
        d["final_cost_rel"] = abs(float(res.final_cost)
                                  / float(ref.final_cost) - 1.0)
        d["offsets_rel"] = float((res.offsets - ref.offsets).abs().max()) \
            / max(1.0, float(ref.offsets.abs().max()))
        d["n_valid_equal"] = int(res.n_valid) == int(ref.n_valid)
        ok = (max(d["q"], d["t"], d["idepths"], d["gains"]) <= 1e-5
              and d["final_cost_rel"] <= 1e-5 and d["offsets_rel"] <= 1e-4
              and d["n_valid_equal"])
        ba_ok &= ok
        ba_rows[f"shards_{nsh}"] = dict(t_sh, diff=d, within_bounds=ok)
    uv_obs, obs_ok = ba_mod.match_window_points(
        win[0][0], win[1][0], win[2][0], *win[:3], uv, d0, pv, cam=cam)
    uv_obs, obs_ok = ba_mod.refine_matches_2d(win[0][0], uv, win[0], uv_obs,
                                              obs_ok)
    no_sync(lambda: ba_mod.bundle_adjust_window_sharded(
        [dev] * 2, *win, uv_obs=uv_obs, obs_valid=obs_ok, ref_index=0, **kw))
    # The nodelet with ba_sharded=True (one card: one block) against phase
    # 9's run, frame by frame over its first frames (two solves).
    n_nd = nodelet_frames
    sh_params = dataclasses.replace(params, pose_tracking=dataclasses.replace(
        ptp, ba_sharded=True))
    node = FlameNodelet(cam, sh_params, pose_source="tracking",
                        ba_refine=True, eval_gt_depth=True, trajectory_cap=0,
                        device=dev)
    assert node.ba_devices(ptp.ba_budget) == [node.engine.device]
    stats = []
    node.on_stats.append(stats.append)
    t_nd = time.perf_counter()
    with CallTimer(nodelet_mod, "hybrid_bundle_adjust_sharded") as hs:
        offline_runner.run_offline_tracking(
            offline_runner.synthetic_frames(seq), cam, sh_params,
            out_dir=os.path.join(out, "tracking_ba_sharded"),
            max_frames=n_nd, device=dev, node=node)
    traj9 = list(node9.trajectory)[:n_nd]
    same_traj = len(node.trajectory) == len(traj9) and all(
        a[0] == b[0] and torch.equal(a[2].q, b[2].q)
        and torch.equal(a[2].t, b[2].t)
        for a, b in zip(node.trajectory, traj9))
    keys = (*DEVICE_STATS_KEYS, "img_id", "track_cost", "track_n_valid",
            "track_n_inliers")

    def rows(recs):
        return repr([tuple(r.get(k) for k in keys) for r in recs])

    same_stats = len(stats) == n_nd and rows(stats) == rows(stats9[:n_nd])
    n_solves = len(node.ba_costs)
    same_costs = node.ba_costs == node9.ba_costs[:n_solves]
    phase("multi_device_ba", points=Pb, selected=n_sel,
          valid_points=int(pv.sum()), card=smi,
          solves=ba_rows, within_bounds=ba_ok, no_host_sync=True,
          nodelet_frames=n_nd, nodelet_seconds=time.perf_counter() - t_nd,
          nodelet_sharded_calls=len(hs.events),
          nodelet_solves=n_solves, nodelet_trajectory_equal=same_traj,
          nodelet_stats_equal=same_stats, nodelet_ba_costs_equal=same_costs)
    assert ba_ok, ba_rows
    assert len(hs.events) == n_solves >= 1, (len(hs.events), n_solves)
    assert same_traj and same_stats and same_costs

    # (d) two processes sharing the card -----------------------------------
    section["c"], t_sec = time.perf_counter() - t_sec, time.perf_counter()
    workers = run_workers(dev, out)
    section["d"] = time.perf_counter() - t_sec
    phase("multi_device_processes", card=smi, **workers)
    phase("multi_device", seconds=time.perf_counter() - t_phase,
          section_seconds=section, profiler_seconds=sum(prof_s),
          profiled_calls=len(prof_s))


def dist_smoke_workers(dev, out):
    """Phase 13 (b): `parallel/dist_smoke.py` as two gloo ranks sharing
    the card (the feature axis across them), beside the single-process
    plain step. Every process is stopped before this returns."""
    import socket
    from flame_ros_torch.parallel import dist_smoke
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    port = str(sk.getsockname()[1])
    sk.close()
    on = ["--device", "cpu"] if dev.type == "cpu" else []
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "flame_ros_torch.parallel.dist_smoke",
         str(r), "2", port, *on], cwd=REPO, env=dict(os.environ,
                                                     PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    try:
        single = dist_smoke.single_coverage(dev)
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    lines = []
    for r, (p, o) in enumerate(zip(procs, outs)):
        ok = [x for x in o.splitlines() if x.startswith(f"DIST_OK pid={r} ")]
        assert p.returncode == 0 and ok, f"rank {r}: {o[-2000:]}"
        lines.append(ok[0])
    covs = [float(x.split("cov=")[1]) for x in lines]
    assert all(c == single[0] for c in covs + single), (covs, single)
    return dict(lines=lines, single_process_coverage=single,
                seconds=time.perf_counter() - t0)


def last_modules_path(seq, ms4, res4, params, cam, dev, out, smi):
    """Phase 13: the feature-axis layout, the cross-process feature axis,
    the bf16 epipolar gathers and the matmul NLTGV2 adjoint. ms4 and
    res4: phase 4's steady host ms per frame and its RunResult."""
    import numpy as np
    import torch
    from flame_ros_torch.geometry.se3 import SE3
    from flame_ros_torch.models.engine import (Flame, _epipolar_step,
                                               _smooth_pd_setup,
                                               state_leaves)
    from flame_ros_torch.ops import nltgv2 as reg_ops
    from flame_ros_torch.ops import raster_cuda as rc
    from flame_ros_torch.ops.pyramid import build_pyramid
    from flame_ros_torch.parallel import feat_shard
    from flame_ros_torch.parallel import multi_stream as ms_mod
    from flame_ros_torch.parallel.multi_stream import MultiStreamRunner
    t_phase = time.perf_counter()
    imgs = torch.clamp(seq.images, 0, 255).to(torch.uint8).cpu().numpy()
    seq_np = (imgs, seq.depths.cpu().numpy(), seq.poses.q.cpu().numpy(),
              seq.poses.t.cpu().numpy(), np.asarray(seq.timestamps))
    n, S = 13, 2

    def drive(r):
        t_upd, rows = [], []
        for i in range(n):
            frames, _ = ms_frames(seq_np, i, S, SE3)
            t0 = time.perf_counter()
            r.update(frames)
            rows.append(r.flush_stats())
            t_upd.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(t_upd), rows

    def timing(ms_arr, r):
        steady = ms_arr[3:]
        frames, _ = ms_frames(seq_np, n, S, SE3)
        ev, busy = device_events(lambda: r.update(frames))
        return {"ms_per_update_p50": float(np.percentile(steady, 50)),
                "ms_per_update_p95": float(np.percentile(steady, 95)),
                "aggregate_frames_per_s": float(
                    S * len(steady) / (steady.sum() / 1e3)),
                "launches_per_update": ev, "busy_ms_per_update": busy}

    # (a) the feature-axis layout on one card -------------------------------
    plain = MultiStreamRunner(cam, S, params=params, device=dev)
    with vmap_fallback_errors():
        p_ms, p_rows = drive(plain)
    p_leaves = [t.clone() for t in state_leaves(plain.states)]
    p_time = timing(p_ms, plain)
    ids = [max(n - 1 - k, 0) for k in range(S)]
    meta = torch.zeros((S, 10), dtype=torch.float32, device=dev)
    meta[:, :4] = seq.poses.q[ids].to(dev)
    meta[:, 4:7] = seq.poses.t[ids].to(dev)
    meta[:, 7] = torch.tensor(ids, dtype=torch.float32, device=dev)
    b_imgs = torch.from_numpy(imgs[ids]).to(dev)
    for F in (2, 4):
        fr = MultiStreamRunner(cam, S, params=params,
                               mesh=ms_mod.make_mesh([dev] * F,
                                                     stream_axis=1))
        assert fr.feat and len(fr.groups) == 1, fr.groups
        rc.reset_counters()
        with vmap_fallback_errors():
            f_ms, f_rows = drive(fr)
        counts = batched_counts(rc, dev)
        launched = list(fr.group_launches)
        differ = [j for j, (a, b) in enumerate(zip(
            state_leaves(fr.states), p_leaves)) if not torch.equal(a, b)]
        stats_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1.0)
                        for ra, rb in zip(f_rows, p_rows)
                        for a, b in zip(ra, rb) for k in a)
        for is_pf in (False, True):
            no_sync(lambda: feat_shard.feat_full_step(
                fr._gstates[0], fr._lanes[0], b_imgs, meta, None, cam=cam,
                params=fr.params, is_pf=is_pf, kf_slot=0))
        phase("last_modules_feat", streams=S, feat=F, frames=n, card=smi,
              leaves_differ=differ, stats_max_rel_diff=stats_rel,
              no_host_sync=True, launches=launched,
              counts=counts, feat_timing=timing(f_ms, fr),
              plain_timing=p_time)
        assert not differ, f"feat {F}: leaves {differ} differ from plain"
        assert stats_rel <= 1e-5, stats_rel
        assert launched == [n], launched
        assert counts == {"v4_batched": n, "v4_batched_images": n * S,
                          "work_v4_batched": n,
                          "work_v4_batched_images": n * S, "v4": 0,
                          "v2": 0, "v3": 0}, counts
        fr.shutdown()
    plain.shutdown()
    t_a = time.perf_counter() - t_phase

    # (b) the feature axis across two processes ----------------------------
    t0 = time.perf_counter()
    phase("last_modules_dist_smoke", card=smi, **dist_smoke_workers(dev, out))
    t_b = time.perf_counter() - t0

    # (c) bf16 epipolar gathers, (d) the matmul adjoint: phase 4's frames,
    # after phase 4's own run again (its digits; the ms/frame baseline
    # taken beside them).
    t0 = time.perf_counter()
    engines = {}
    for name, upd, ref in (
            ("float32", {}, None),
            ("bfloat16", {"compute_dtype": "bfloat16"}, JAX_BF16_VGA),
            ("matmul", {"nltgv2_adjoint": "matmul"}, JAX_MATMUL_VGA)):
        prm = dataclasses.replace(params, engine=dataclasses.replace(
            params.engine, **upd))
        eng = Flame(cam.width, cam.height, cam=cam, params=prm, device=dev)
        rc.reset_counters()
        out_dir = os.path.join(out, f"option_{name}")
        os.makedirs(out_dir, exist_ok=True)
        res, ms, checked, _, _, _, recs = drive_main_path(eng, seq, out_dir)
        launches, work = launch_counts(rc, dev)
        if ref is None:       # phase 4 again: the same digits
            ref = {"idepth_rmse": res4.mean_rmse,
                   "recall": res4.mean_recall,
                   "coverage": res4.final_coverage}
            assert (res.mean_rmse, res.mean_recall, res.final_coverage) \
                == tuple(ref.values()), (res, ref)
        diff, ok = jax_band(res, ref)
        nf = len(seq.timestamps)
        phase(f"last_modules_{name}", card=smi, frames=res.frames_processed,
              mean_rmse=res.mean_rmse, mean_recall=res.mean_recall,
              mean_precision=res.mean_precision,
              final_coverage=res.final_coverage, reference=ref, band=JAX_BAND,
              diff=diff, within_band=ok,
              ms_per_frame_p50=float(np.percentile(ms[5:], 50)),
              ms_per_frame_p95=float(np.percentile(ms[5:], 95)),
              phase4_ms_per_frame_p50=float(np.percentile(ms4, 50)),
              launches=launches, work=work, idmap_checked_frames=checked)
        assert res.frames_processed == nf and res.frames_failed == 0, res
        assert all(r["health"] == 1.0 for r in recs)
        assert launches["v4"] >= nf and launches["v2"] == 0 \
            and launches["v3"] == 0, launches
        assert work == launches and len(checked) == 6, (work, checked)
        assert ok, (name, diff)
        engines[name] = eng

    # The epipolar update (f32 vs bf16 gathers) and the sweep (gather vs
    # matmul adjoint) on the final states' inputs.
    st = engines["bfloat16"].state
    last = len(seq.timestamps) - 1
    pyr = build_pyramid(seq.images[last].to(dev, torch.float32), 3)
    cq, ct = seq.poses.q[last].to(dev), seq.poses.t[last].to(dev)
    ops = {}
    for dt in ("float32", "bfloat16"):
        prm = dataclasses.replace(params, engine=dataclasses.replace(
            params.engine, compute_dtype=dt))

        def epi(prm=prm):
            return _epipolar_step(st.feat, st.kf_pyrs, st.kf_q, st.kf_t, pyr,
                                  cq, ct, cam=cam, params=prm)
        ev, busy = device_events(epi)
        ops[f"epipolar_{dt}"] = {"ms": cuda_median_ms(epi),
                                 "launches": ev, "busy_ms": busy}
    st = engines["matmul"].state
    e, nl = params.engine, params.regularization.nltgv2
    _, edge_fresh, lam = _smooth_pd_setup(st, params=engines["matmul"].params)
    top = reg_ops.build_topology(st.edges, edge_fresh, st.vtx_uv,
                                 inc_edges=st.inc_edges,
                                 inc_sign=st.inc_sign)
    gs = reg_ops.GraphState(x=st.vtx_x, w=st.vtx_w, q=st.edge_q,
                            x_bar=st.vtx_x, w_bar=st.vtx_w)
    N = int(st.vtx_x.shape[0])
    for adj in ("gather", "matmul"):
        def sweep(adj=adj):
            g = (reg_ops.build_gcat(st.edges, edge_fresh, N)
                 if adj == "matmul" else None)
            return reg_ops.pd_iterate(
                gs, top, st.vtx_z, lam, st.vtx_in_graph, g,
                num_iters=e.pd_iters_per_frame, theta=nl.theta,
                gate_tol=e.pd_gate_tol)
        ev, busy = device_events(sweep)
        ops[f"sweep_{adj}"] = {"ms": cuda_median_ms(sweep),
                               "launches": ev, "busy_ms": busy}
        if adj == "matmul":
            no_sync(sweep)
    gout = reg_ops.pd_iterate(gs, top, st.vtx_z, lam, st.vtx_in_graph,
                              num_iters=e.pd_iters_per_frame, theta=nl.theta,
                              gate_tol=e.pd_gate_tol)
    mout = reg_ops.pd_iterate(gs, top, st.vtx_z, lam, st.vtx_in_graph,
                              reg_ops.build_gcat(st.edges, edge_fresh, N),
                              num_iters=e.pd_iters_per_frame, theta=nl.theta,
                              gate_tol=e.pd_gate_tol)
    live = st.vtx_in_graph
    sweep_diff = max(float((mout.x - gout.x)[live].abs().max()),
                     float((mout.w - gout.w)[live].abs().max()))
    phase("last_modules_ops", card=smi, ops=ops,
          gcat_bytes=N * 2 * int(st.edges.shape[0]) * 4,
          matmul_minus_gather_xw_max_abs=sweep_diff,
          matmul_sweep_no_host_sync=True,
          seconds={"a": t_a, "b": t_b, "cd": time.perf_counter() - t0,
                   "total": time.perf_counter() - t_phase})
    assert sweep_diff <= 2e-3, sweep_diff


def viz_path(engine, seq, params, cam, dev, out):
    """Phase 11: the viz modules on phase 4's final engine, and the live
    viewer against a FlameServer on the card."""
    import importlib.util
    import re
    import threading
    import urllib.request
    import numpy as np
    import torch
    from flame_ros_torch.frontends.serve import FlameServer
    from flame_ros_torch.viz import debug_images as dbg
    from flame_ros_torch.viz.export import write_ply_mesh
    from flame_ros_torch.viz.html_viewer import export_html_viewer
    from flame_ros_torch.viz.live_viewer import LiveMeshViewer
    flags = ("wireframe", "features", "idepthmap", "matches", "detections",
             "normals")
    gray = torch.clamp(seq.images[-1], 0, 255).to(torch.uint8).cpu().numpy()
    base = dict.fromkeys(flags, False)

    def render(**on):
        engine.params = dataclasses.replace(
            engine.params, debug=dataclasses.replace(
                engine.params.debug, profile_stages=False,
                text_overlay=False, flip_images=False, **{**base, **on}))
        return dbg.render_debug_images(engine, gray)

    products = render(**dict.fromkeys(flags, True))
    assert sorted(products) == sorted(flags), sorted(products)
    for k, im in products.items():
        assert im.shape == (cam.height, cam.width, 3) and \
            im.dtype == np.uint8, (k, im.shape, im.dtype)
    finite = np.isfinite(engine.get_inverse_depth_map())
    colored = (products["idepthmap"] != np.stack([gray] * 3, -1)).any(-1)
    assert np.array_equal(colored, finite), int((colored != finite).sum())
    host_ms = {}
    for k in flags:
        t0 = time.perf_counter()
        render(**{k: True})
        host_ms[k] = (time.perf_counter() - t0) * 1e3

    # The final mesh as PLY and as the HTML viewer, read back.
    uv, x, normals, tris, keep, _ = engine.get_inverse_depth_mesh()
    ply = os.path.join(out, "final_mesh.ply")
    write_ply_mesh(ply, uv, x, normals, tris, keep, cam.K, width=cam.width,
                   height=cam.height)
    with open(ply, "rb") as f:
        head = f.read(1024).split(b"end_header")[0].decode()
    n_v = int(re.search(r"element vertex (\d+)", head).group(1))
    n_f = int(re.search(r"element face (\d+)", head).group(1))
    html = os.path.join(out, "final_mesh.html")
    export_html_viewer(html, uv, x, normals, tris, keep, cam.K, gray=gray)
    with open(html) as f:
        page = f.read()
    data = json.loads(page.split("const DATA = ", 1)[1].split(
        ";\nconst cv", 1)[0])
    assert n_v == len(uv) == len(data["xyz"]) // 3, (n_v, len(uv))
    assert n_f == int(keep.sum()) == len(data["tris"]) // 3 > 0, n_f
    assert data["texture_png"], "no texture (cv2.imencode)"

    # A FlameServer on the card, fed 10 frames by the feeder script
    # (scripts/stream_synthetic_torch.py, phase 4's sequence rendered on
    # the card), streams to a LiveMeshViewer.
    spec = importlib.util.spec_from_file_location(
        "stream_synthetic_torch",
        os.path.join(REPO, "scripts", "stream_synthetic_torch.py"))
    feeder = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(feeder)
    srv = FlameServer(cam, params, port=0, device=dev)
    srv.start()
    viewer = LiveMeshViewer(server_port=srv.port, http_port=0,
                            period_s=0.1).start()
    url = f"http://127.0.0.1:{viewer.http_port}"
    fed = []
    feed = threading.Thread(target=lambda: fed.append(feeder.main(
        ["--port", str(srv.port), "--frames", "10", "--rate", "10",
         "--resolution", "vga", "--device", str(dev)]) or True))

    def poll_tris():
        """Triangles of the viewer's mesh JSON, None before the first."""
        with urllib.request.urlopen(url + "/mesh.json", timeout=10) as r:
            if r.status != 200:
                return None
            d = json.loads(r.read())
        assert len(d["xyz"]) > 0, "empty mesh JSON"
        return len(d["tris"]) // 3

    seen = []
    try:
        with urllib.request.urlopen(url + "/", timeout=10) as r:
            assert r.status == 200 and b"mesh.json" in r.read()
        feed.start()
        while feed.is_alive():
            seen.append(poll_tris())
            time.sleep(0.1)
        feed.join()
        assert fed == [True], "the feeder failed"
        deadline = time.time() + 60
        while time.time() < deadline:
            seen.append(poll_tris())
            if seen[-1]:
                break
            time.sleep(0.2)
    finally:
        if feed.is_alive():
            feed.join(timeout=60)
        viewer.stop()
        srv.stop()
    got = [s for s in seen if s is not None]
    assert got and got[-1] > 0 and got[-1] > got[0], seen
    phase("viz", products=sorted(products), host_ms_per_product=host_ms,
          idepthmap_colored_px=int(colored.sum()),
          ply_vertices=n_v, ply_faces=n_f, html_vertices=n_v,
          html_faces=n_f, live_viewer_tris=got)


# Phase 14: a poseframe check frame after the third wrap of the keyframe
# ring (a poseframe every 6 frames, 8 slots: the third wrap is frame 144)
# and a non-poseframe one after the second.
ACCEPT_CHECK = {"frame": 97, "poseframe": 150}


def accept_tree(name, seq, root):
    """Write an acceptance run's sequence as its TUM or ASL tree under
    root, as tests/test_acceptance_stress.py does; the offline runner's
    arguments that read it back."""
    from flame_ros_torch.datasets.synthetic import export_asl, export_tum
    if ACCEPT_RUNS[name]["dataset"] == "tum":
        assoc, calib = export_tum(seq, os.path.join(root, "tum"))
        return ["--dataset", "tum", "--input", assoc, "--calib", calib]
    mav0 = os.path.join(root, "mav0")
    export_asl(seq, mav0)
    return ["--dataset", "asl",
            "--pose-path", os.path.join(mav0, "state_groundtruth_estimate0"),
            "--rgb-path", os.path.join(mav0, "cam0"),
            "--depth-path", os.path.join(mav0, "depth0"),
            "--world-frame", "RDF"]


def acceptance_run(name, device, out_dir):
    """One run of ACCEPT_RUNS through the port's CLI, `offline_runner.
    main`, on `device` (the synthetic runs render there; tum and asl
    render there, are written as a tree and read back). The runner's
    `run_offline` is wrapped to keep its engine and to time each frame on
    the host clock from its start to the end of its stats read. The id
    buffer is recomputed (check_idmap) after frame ACCEPT_CHECK["frame"]
    and on poseframe ACCEPT_CHECK["poseframe"] before its install; on the
    card, v4 must launch on every frame and v2 and v3 on none (wrapper
    counts and device work counters). Returns a dict: the CLI's summary
    line, the run's unrounded metrics, ms per frame, launches, work, the
    checks and the frame_digest of every frame the run read (tum and asl:
    of the sequence written as the tree)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from flame_ros_torch.datasets.synthetic import VGA, make_sequence
    from flame_ros_torch.frontends import offline_runner
    from flame_ros_torch.models.engine import Flame
    from flame_ros_torch.ops import raster_cuda as rc
    spec = ACCEPT_RUNS[name]
    dev = torch.device(device)
    run_dir = os.path.join(out_dir, name)
    os.makedirs(run_dir, exist_ok=True)
    t0 = time.perf_counter()
    digests = []
    synthetic = spec.get("dataset", "synthetic") == "synthetic"
    if synthetic:
        argv = accept_argv(name)
    else:
        seq = make_sequence(ACCEPT_FRAMES, VGA, device=dev,
                            **accept_sequence(name))
        digests = sequence_digests(seq)
        argv = accept_tree(name, seq, os.path.join(run_dir, "tree"))
        del seq
    t_tree = time.perf_counter() - t0
    argv += ["--device", str(dev), "--out", run_dir]
    starts, ends, marks, checks, skip = [], [], [], [], {}
    held = {}
    orig = offline_runner.run_offline

    def check(engine, frame, poseframe):
        t = time.perf_counter()
        n_px, _ = check_idmap(engine, frame)
        checks.append({"frame": frame, "poseframe": poseframe,
                       "poseframes_so_far": engine._num_poseframes,
                       "order_split_px": n_px})
        return time.perf_counter() - t

    def frames(engine, it):
        for i, f in enumerate(it):
            if i:
                ends.append(time.perf_counter())
            if i - 1 == ACCEPT_CHECK["frame"]:
                # Between two frames' windows: not timed.
                check(engine, i - 1, False)
            if synthetic:
                digests.append(frame_digest(f.gray, f.depth, f.quat,
                                            f.trans))
            marks.append(rc.rasterize_tri_ids_v4.launches)
            starts.append(time.perf_counter())
            yield f
        ends.append(time.perf_counter())
        marks.append(rc.rasterize_tri_ids_v4.launches)

    def traced(it, cam, params, device=None, **kw):
        engine = Flame(cam.width, cam.height, cam=cam, params=params,
                       device=device)
        held["engine"] = engine
        retri = engine._retriangulate

        def retriangulate():
            # The poseframe's raster inputs, before its install.
            # Inside the frame's window: its seconds come off the frame.
            frame = engine._frame_count - 1
            if frame == ACCEPT_CHECK["poseframe"]:
                skip[frame] = check(engine, frame, True)
            retri()

        engine._retriangulate = retriangulate
        return orig(frames(engine, it), cam, params, device=device,
                    engine=engine, **kw)

    rc.reset_counters()
    line = io.StringIO()
    offline_runner.run_offline = traced
    try:
        with contextlib.redirect_stdout(line):
            res = offline_runner.main(argv)
    finally:
        offline_runner.run_offline = orig
    launches, work = launch_counts(rc, dev) if dev.type == "cuda" else (
        {"v4": rc.rasterize_tri_ids_v4.launches,
         "v2": rc.rasterize_tri_ids_v2.launches,
         "v3": rc.rasterize_tri_ids_v3.launches}, None)
    printed = json.loads(line.getvalue().strip().splitlines()[-1])
    with open(os.path.join(run_dir, "telemetry.jsonl")) as f:
        health = [json.loads(r)["health"] for r in f]
    ms = (np.asarray(ends) - np.asarray(starts)) * 1e3
    for frame, secs in skip.items():
        ms[frame] -= secs * 1e3
    per_frame = np.diff(np.asarray(marks))
    engine = held["engine"]
    K = engine.params.engine.max_keyframes
    summary = {"frames": res.frames_processed, "failed": res.frames_failed,
               "idepth_rmse": res.mean_rmse,
               "precision": res.mean_precision, "recall": res.mean_recall,
               "coverage": res.final_coverage, "abs_rel": res.final_abs_rel,
               "delta1": res.final_delta1}
    summary = {k: (float(v) if isinstance(v, (float, np.floating)) else v)
               for k, v in summary.items()}
    steady = ms[5:]
    out = {"run": name, "argv": argv[:-4], "summary": summary,
           "printed": printed, "tree_s": t_tree, "digests": digests,
           "ms_per_frame_p50": float(np.percentile(steady, 50)),
           "ms_per_frame_p95": float(np.percentile(steady, 95)),
           "launches": launches, "work": work, "checks": checks,
           "health_all_ready": all(h == 1.0 for h in health)}
    assert printed["frames"] == summary["frames"] == ACCEPT_FRAMES, out
    assert printed["failed"] == summary["failed"] == 0, out
    assert len(health) == ACCEPT_FRAMES and out["health_all_ready"], out
    assert len(digests) == ACCEPT_FRAMES, len(digests)
    assert [c["frame"] for c in checks] == [ACCEPT_CHECK["frame"],
                                           ACCEPT_CHECK["poseframe"]], checks
    assert checks[1]["poseframes_so_far"] > 3 * K, checks
    if dev.type == "cuda":
        # v4 on every frame (its wrapper's count moves in each), the
        # device's own count agreeing, v2 and v3 never.
        assert len(per_frame) == ACCEPT_FRAMES and per_frame.min() >= 1, \
            per_frame.tolist()
        assert launches["v2"] == 0 and launches["v3"] == 0, launches
        assert work == {"v4": launches["v4"], "v2": 0, "v3": 0}, work
    else:
        assert launches == {"v4": 0, "v2": 0, "v3": 0}, launches
    return out


def accept_verdict(name, summary, ref, other=None):
    """The port's run `summary` against the JAX package's run `ref` of the
    same frames: rmse, recall and coverage within JAX_BAND; each of the
    JAX test's gates that the JAX run passes, passed; the gates the JAX
    run fails listed (the port is held to the JAX run there, by the
    band). For exposure_b, other = (the port's exposure_a summary, the
    JAX one): B must beat A on each of EXPOSURE_AB where JAX's B does.
    Returns (verdict dict, ok)."""
    diff = {"idepth_rmse": abs(summary["idepth_rmse"] - ref["idepth_rmse"])
            / ref["idepth_rmse"],
            "recall": abs(summary["recall"] - ref["recall"]),
            "coverage": abs(summary["coverage"] - ref["coverage"])}
    in_band = all(diff[k] <= JAX_BAND[k] for k in diff)
    port = gate_results(summary, ACCEPT_RUNS[name]["gates"])
    jax = gate_results(ref, ACCEPT_RUNS[name]["gates"])
    must = [p for p, j in zip(port, jax) if j[4]]
    held = [f"{k} {op} {b}" for k, op, b, _, ok in jax if not ok]
    failed = [f"{k} {op} {b}: {v}" for k, op, b, v, ok in must if not ok]
    v = {"band_diff": diff, "in_band": in_band,
         "gates_passed_by_jax": [f"{k} {op} {b}" for k, op, b, *_ in must],
         "gates_failed": failed, "held_to_jax_run": held,
         "jax": {k: ref[k] for k in ("idepth_rmse", "precision", "recall",
                                     "coverage", "abs_rel", "delta1")}}
    ok = in_band and not failed
    if other is not None:
        a, ja = other
        beats = {k: (summary[k] < a[k] if op == "<" else summary[k] > a[k])
                 for k, op in EXPOSURE_AB}
        jax_beats = {k: (ref[k] < ja[k] if op == "<" else ref[k] > ja[k])
                     for k, op in EXPOSURE_AB}
        v["beats_exposure_a"], v["jax_beats_exposure_a"] = beats, jax_beats
        ok = ok and all(beats[k] for k in beats if jax_beats[k])
    return v, ok


def sequence_key(n, kw):
    """A file name for the n-frame sequence of make_sequence(**kw)."""
    return "_".join([str(n)] + [f"{k}-{kw[k]}" for k in sorted(kw)])


def frame_digest(gray, depth, q, t):
    """One frame as the engine and the tracker read it: digests of the
    bytes of its float32 image, GT depth, rotation and translation."""
    import hashlib
    import numpy as np
    out = []
    for x in (gray, depth, q, t):
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        out.append(hashlib.sha1(np.ascontiguousarray(x).tobytes())
                   .hexdigest()[:16])
    return out


def sequence_digests(seq):
    """frame_digest of every frame of a SyntheticSequence."""
    q = seq.poses.q.detach().cpu().numpy()
    t = seq.poses.t.detach().cpu().numpy()
    return [frame_digest(seq.images[i], seq.depths[i], q[i], t[i])
            for i in range(len(seq))]


def frames_differ(card, cpu):
    """Per field of frame_digest, the frames whose digests differ between
    two lists of them (of the same sequence)."""
    assert len(card) == len(cpu), (len(card), len(cpu))
    return {f: [i for i, (a, b) in enumerate(zip(card, cpu)) if a[j] != b[j]]
            for j, f in enumerate(("image", "depth", "q", "t"))}


def cpu_frame_digests(jobs, out_dir, threads):
    """For each (n, kws) of jobs, kws the make_sequence keyword arguments
    of sequences that differ only in their knobs (texture_gain,
    exposure_amp), the n-frame sequences rendered on the CPU with
    `threads` intra-op threads over one rendering of the scene
    (make_sequences), each one's sequence_digests written to
    out_dir/<sequence_key>.json."""
    sys.path.insert(0, REPO)
    import torch
    from flame_ros_torch.datasets.synthetic import VGA, make_sequences
    torch.set_num_threads(threads)
    for n, kws in jobs:
        seqs = make_sequences(
            n, VGA, [(kw["texture_gain"], kw["exposure_amp"]) for kw in kws],
            motion=kws[0]["motion"], scene=kws[0]["scene"], device="cpu")
        for kw, seq in zip(kws, seqs):
            path = os.path.join(out_dir, sequence_key(n, kw) + ".json")
            with open(path + ".tmp", "w") as f:
                json.dump(sequence_digests(seq), f)
            os.replace(path + ".tmp", path)


class CpuFrames:
    """The CPU's frames of every sequence the card's phases read (phase
    4's 60 frames and each distinct sequence of ACCEPT_RUNS at 200), as
    frame digests made by cpu_frame_digests in a process of its own,
    which runs beside the card's phases on `threads` cores, in the order
    phase 14 asks for them. The JAX package's runs that phases 9, 13 and
    14 are held to read these frames."""

    def __init__(self, out, threads=4):
        import multiprocessing
        self.dir = os.path.join(out, "cpu_frames")
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir)
        scenes = {}
        for name in ACCEPT_RUNS:
            kw = accept_sequence(name)
            kws = scenes.setdefault((kw["motion"], kw["scene"]), [])
            if kw not in kws:
                kws.append(kw)
        jobs = [(60, [accept_sequence("default")])] + [
            (ACCEPT_FRAMES, kws) for kws in scenes.values()]
        self.proc = multiprocessing.get_context("spawn").Process(
            target=cpu_frame_digests, args=(jobs, self.dir, threads),
            daemon=True)
        self.proc.start()

    def digests(self, n, kw, timeout=900.0):
        """The CPU's digests of the n-frame sequence of kw, waited for."""
        path = os.path.join(self.dir, sequence_key(n, kw) + ".json")
        end = time.monotonic() + timeout
        while not os.path.exists(path):
            if not self.proc.is_alive() and not os.path.exists(path):
                raise RuntimeError("the CPU renderer ended with code "
                                   f"{self.proc.exitcode} before {path}")
            if time.monotonic() > end:
                raise TimeoutError(f"no CPU frames {path} in {timeout} s")
            time.sleep(0.2)
        with open(path) as f:
            return json.load(f)

    def close(self):
        self.proc.join(timeout=60)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()


def acceptance_path(dev, out, smi, cpu_frames):
    """Phase 14: the ten runs of ACCEPT_RUNS on the card, each reading the
    CPU's frames bit for bit (every frame's digests against cpu_frames, a
    CpuFrames) and held to its JAX run of those frames (JAX_ACCEPT_VGA200)
    by accept_verdict."""
    t_phase = time.perf_counter()
    root = os.path.join(out, "accept")
    runs, fails = {}, []
    for name in ACCEPT_RUNS:
        t0 = time.perf_counter()
        r = acceptance_run(name, dev, root)
        other = None
        if name == "exposure_b":
            other = (runs["exposure_a"]["summary"],
                     JAX_ACCEPT_VGA200["exposure_a"])
        verdict, ok = accept_verdict(name, r["summary"],
                                     JAX_ACCEPT_VGA200[name], other)
        t1 = time.perf_counter()
        differ = frames_differ(r["digests"], cpu_frames.digests(
            ACCEPT_FRAMES, accept_sequence(name)))
        same = not any(differ.values())
        runs[name] = r
        phase("acceptance", run=name, card=smi, ok=ok and same,
              verdict=verdict, frames_equal_cpu=same,
              frames_differ=differ, cpu_frames_wait_s=time.perf_counter() - t1,
              jax_test=ACCEPT_RUNS[name]["test"],
              seconds=time.perf_counter() - t0,
              **{k: r[k] for k in ("argv", "summary", "ms_per_frame_p50",
                                   "ms_per_frame_p95", "launches", "work",
                                   "checks", "tree_s")})
        if not (ok and same):
            fails.append(name)
    phase("acceptance_total", card=smi, runs=len(runs),
          v4_launches={k: r["launches"]["v4"] for k, r in runs.items()},
          seconds=time.perf_counter() - t_phase)
    assert not fails, f"acceptance runs outside the JAX run: {fails}"


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import flame_ros_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the flame_ros_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    import numpy as np
    from flame_ros_torch.config import FlameParams
    from flame_ros_torch.datasets.synthetic import VGA, make_sequence
    from flame_ros_torch.eval.metrics import TruthStats
    from flame_ros_torch.frontends.offline_runner import (
        run_offline, run_offline_windowed, synthetic_frames)
    from flame_ros_torch.geometry.camera import Pinhole
    from flame_ros_torch.geometry.se3 import SE3
    from flame_ros_torch.graph.delaunay import native_available, triangulate
    from flame_ros_torch.models.engine import Flame, state_to_numpy
    from flame_ros_torch.ops import raster_cuda as rc
    from flame_ros_torch.utils.stage_profiler import STAGES
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")

    # 1. environment ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    max_sm_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    phase("environment", card=smi, kind=kind, max_sm_clock=max_sm_clock,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          tf32_matmul=False, tf32_cudnn=False)
    # The CPU's frames of every sequence the card's phases read, rendered
    # beside them (phases 4 and 14 compare).
    cpu_frames = CpuFrames(OUT)

    # 2. kernel build --------------------------------------------------
    t0 = time.perf_counter()
    so = rc.build(force=True)
    t_nvcc = time.perf_counter() - t0
    rc._get_lib()
    t0 = time.perf_counter()
    assert native_available(), "native Delaunay failed to build"
    phase("build", library=os.path.relpath(so, REPO),
          nvcc_seconds=round(t_nvcc, 3),
          delaunay_seconds=round(time.perf_counter() - t0, 3))

    # 3. kernels vs plain versions -------------------------------------
    H, W = VGA.height, VGA.width
    meshes = make_meshes(triangulate, np, H, W)
    names = ("v4", "v2", "v3")
    funcs = {"v4": (rc.rasterize_tri_ids_v4, rc.rasterize_tri_ids_v4_ref),
             "v2": (rc.rasterize_tri_ids_v2, rc.rasterize_tri_ids_v2_ref),
             "v3": (rc.rasterize_tri_ids_v3, rc.rasterize_tri_ids_v3_ref)}
    rows = {n: {} for n in names}
    max_err = {n: 0 for n in names}
    for case, ((pos, tp, tv), kws) in meshes.items():
        args = [torch.from_numpy(a).to(dev) for a in (pos, tp, tv)]
        fits3 = v3_budgets_hold(rc, args, H, kws.get("v3", {}))
        if case == "forced_fallback":
            assert not fits3
        _, lo_pos, hi_pos, counts = rc.v4_setup(*args, height=H, row_tile=2,
                                                long_thresh=48.0)
        n_short, n_live = counts.tolist()
        v4_range = int((hi_pos - lo_pos).max()) + n_live - n_short
        if case == "multi_chunk":
            assert v4_range > 2 * rc.STAGE_CHUNK, v4_range
        pairs = bbox_pairs(torch, *args, H, W)
        outs = {}
        for name in names:
            kern, ref = funcs[name]
            kk = port_kw(kws.get(name, {}))
            rc.reset_counters()
            out = kern(*args, height=H, width=W, **kk)
            torch.cuda.synchronize()
            one_call, work = launch_counts(rc, dev)
            outs[name] = out
            plain = ref(*args, height=H, width=W, **kk)
            torch.cuda.synchronize()
            err = int((out.long() - plain.long()).abs().max())
            max_err[name] = max(max_err[name], err)
            if not torch.equal(out, plain):
                raise AssertionError(
                    f"{name} kernel != plain on {case}: "
                    f"{int((out != plain).sum())} pixels differ")
            # One launch of the kernel called, none of another, whatever
            # the TPU v3's budgets would have done.
            expect = {n: int(n == name) for n in names}
            assert one_call == expect and work == expect, \
                (case, name, one_call, work)
            eq_v2 = name == "v3" and bool(torch.equal(out, outs["v2"]))
            if name == "v3" and not (fits3 or eq_v2):
                # Where the JAX wrapper answers with v2, so must v3.
                raise AssertionError(
                    f"v3 != v2 on {case} (TPU budgets overflow): "
                    f"{int((out != outs['v2']).sum())} pixels differ")
            ms = cuda_median_ms(lambda: kern(*args, height=H, width=W, **kk))
            bare = bare_launch(rc, name, args, H, W, kk)
            kernel_ms = cuda_median_ms(bare)
            kernel_dev_ms = device_ms(bare)
            plain_ms = cuda_median_ms(
                lambda: ref(*args, height=H, width=W, **kk), reps=5,
                warmup=1)
            b_ops = pairs * INSTR_PER_TEST[name] / F32_INSTR_RATE * 1e3
            b_bytes = (bare.slab_bytes + H * W * 4) / PEAK_BYTES * 1e3
            rows[name][case] = dict(
                ms=ms, kernel_only_ms=kernel_ms,
                kernel_device_ms=kernel_dev_ms, plain_ms=plain_ms,
                bound_ms=max(b_ops, b_bytes),
                bound_by="operations" if b_ops >= b_bytes else "bytes",
                bound_ops_ms=b_ops, bound_bytes_ms=b_bytes,
                bbox_pairs=pairs,
                candidate_tests=y_overlap_tests(torch, *args, H, W),
                v4_max_tile_range=v4_range,
                fits=fits3 if name == "v3" else None,
                equals_v2=eq_v2 if name == "v3" else None, work=work,
                covered=float((out >= 0).float().mean()))
            phase("kernel", kernel=name, case=case, equal=True,
                  **rows[name][case])

    # 4. the main path -------------------------------------------------
    n_frames = 60
    params = FlameParams()
    t0 = time.perf_counter()
    seq = make_sequence(n_frames, VGA, motion="strafe", scene="room",
                        device=dev)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    engine = Flame(W, H, cam=VGA, params=params, device=dev)
    assert engine.params.engine.use_pallas_raster is True
    assert engine.params.engine.pallas_raster_kernel == "v4"
    rc.reset_counters()
    res, ms, checked, split, v3_fits, inputs, recs = drive_main_path(
        engine, seq, OUT)
    launches, work = launch_counts(rc, dev)
    assert res.frames_processed == n_frames and res.frames_failed == 0
    health = [r["health"] for r in recs]
    assert len(health) == n_frames and all(h == 1.0 for h in health), health
    assert launches["v4"] >= n_frames, launches
    assert launches["v2"] == 0 and launches["v3"] == 0, launches
    assert work == {"v4": launches["v4"], "v2": 0, "v3": 0}, work
    assert len(checked) == 6, checked
    # The v4 and v2 kernels on the checked frames' inputs: each equal to
    # its plain version; kernel-only (one launch, and back to back on the
    # card) and wrapper medians per frame.
    frame_ms = {"v4": [], "v2": []}
    for args in inputs:
        for name in frame_ms:
            kern, ref = funcs[name]
            out = kern(*args, height=H, width=W)
            if not torch.equal(out, ref(*args, height=H, width=W)):
                raise AssertionError(f"{name} kernel != plain on a "
                                     "main-path frame")
            bare = bare_launch(rc, name, args, H, W, {})
            frame_ms[name].append({
                "kernel_only_ms": cuda_median_ms(bare),
                "kernel_device_ms": device_ms(bare),
                "ms": cuda_median_ms(
                    lambda: kern(*args, height=H, width=W)),
                "bbox_pairs": bbox_pairs(torch, *args, H, W)})
    assert np.isfinite(res.mean_rmse) and res.mean_rmse < 0.1, res
    assert res.final_coverage > 0.3, res
    # The card rendered the CPU's frames, which the JAX runs of phases 9
    # and 13 read: every frame bit for bit.
    t0 = time.perf_counter()
    differ = frames_differ(sequence_digests(seq), cpu_frames.digests(
        n_frames, accept_sequence("default")))
    assert not any(differ.values()), differ
    steady = ms[5:]
    phase("main_path", frames=res.frames_processed,
          render_s=round(t_render, 3), frames_equal_cpu=True,
          cpu_frames_wait_s=time.perf_counter() - t0,
          ms_per_frame_p50=float(np.percentile(steady, 50)),
          ms_per_frame_p95=float(np.percentile(steady, 95)),
          ms_first_frame=float(ms[0]),
          mean_rmse=res.mean_rmse, mean_precision=res.mean_precision,
          mean_recall=res.mean_recall, final_coverage=res.final_coverage,
          final_abs_rel=res.final_abs_rel, final_delta1=res.final_delta1,
          launches=launches, work=work, idmap_checked_frames=checked,
          idmap_order_split_px=split,
          v3_fits_checked_frames=v3_fits,
          checked_frame_times=frame_ms,
          num_tris_last=recs[-1]["num_tris"])

    # The stage profiler on phase 4's engine, after its timed frames:
    # debug.profile_stages on, one more frame (the last one again, as
    # frame 60) through Flame.update, whose hook re-times every stage.
    engine.params = dataclasses.replace(
        engine.params, debug=dataclasses.replace(
            engine.params.debug, profile_stages=True,
            profile_stages_every=1))
    last = n_frames - 1
    assert engine.update(float(seq.timestamps[last]) + 1.0 / 30, n_frames,
                         SE3(seq.poses.q[last].cpu(), seq.poses.t[last].cpu()),
                         seq.images[last], False)
    timings = engine.stats_.timings()
    stage_keys = (*STAGES, "update")
    missing = [k for k in stage_keys if k not in timings]
    assert len(stage_keys) == 13 and not missing, missing
    assert all(timings[k] > 0.0 for k in ("update_idepths", "sync_graph",
                                          "triangulate")), timings
    phase("profile_stages", stage_ms={k: timings[k] for k in stage_keys},
          timed_by="CUDA events around each stage's standalone call "
                   "(triangulate: host clock); update includes the "
                   "profiling pass")

    # 5. the windowed streaming path -----------------------------------
    # (a) windows of 6, synchronous triangulation, the phase-4 sequence,
    # against the JAX package's CPU run of it.
    out_a = os.path.join(OUT, "window_sync")
    os.makedirs(out_a, exist_ok=True)
    eng_a = Flame(W, H, cam=VGA, params=params, device=dev)
    rc.reset_counters()
    t0 = time.perf_counter()
    res_a = run_offline_windowed(synthetic_frames(seq), VGA, params,
                                 out_dir=out_a, window=6, engine=eng_a)
    wall_a = time.perf_counter() - t0
    launches_a, work_a = launch_counts(rc, dev)
    with open(os.path.join(out_a, "telemetry.jsonl")) as f:
        health_a = [json.loads(line)["health"] for line in f]
    assert res_a.frames_processed == n_frames and res_a.frames_failed == 0
    assert health_a == [1.0] * n_frames, health_a
    assert launches_a["v4"] >= n_frames, launches_a
    assert launches_a["v2"] == 0 and launches_a["v3"] == 0, launches_a
    assert work_a == {"v4": launches_a["v4"], "v2": 0, "v3": 0}, work_a
    ref = JAX_WINDOWED_VGA
    band = {"rmse_rel_diff": abs(res_a.mean_rmse - ref["idepth_rmse"])
            / ref["idepth_rmse"],
            "coverage_diff": abs(res_a.final_coverage - ref["coverage"])}
    assert band["rmse_rel_diff"] <= 0.15 and band["coverage_diff"] <= 0.05, \
        (res_a, band)

    # (b) streaming: host frames, prefetch depth 2, deferred triangulation.
    n_b, win = 120, 6
    seq_b = make_sequence(n_b, VGA, motion="strafe", scene="room",
                          device=dev)
    imgs_b = torch.clamp(seq_b.images, 0, 255).to(torch.uint8).cpu().numpy()
    q_b = seq_b.poses.q.cpu().numpy()
    t_b = seq_b.poses.t.cpu().numpy()
    frames_b = [(float(seq_b.timestamps[i]), i,
                 SE3.from_quat_trans(q_b[i], t_b[i]), imgs_b[i], i % 6 == 0)
                for i in range(n_b)]
    eng_b = Flame(W, H, cam=VGA, params=params, device=dev,
                  deferred_triangulation=True)
    rc.reset_counters()
    secs, wrows = stream_windows(eng_b, frames_b, seq_b.depths, win)
    launches_b, work_b = launch_counts(rc, dev)
    pending_at_end = len(eng_b._pending_tri)
    eng_b._apply_pending_triangulation(block=True)
    eng_b.shutdown()
    health_b = [r["health"] for rs in wrows for r in rs]
    assert len(health_b) == n_b and all(h == 1.0 for h in health_b)
    assert eng_b.num_failed_frames == 0
    assert launches_b["v4"] >= n_b, launches_b
    assert launches_b["v2"] == 0 and launches_b["v3"] == 0, launches_b
    assert work_b == {"v4": launches_b["v4"], "v2": 0, "v3": 0}, work_b
    covs = [rs[-1]["coverage"] for rs in wrows]
    cov_steady = covs[4:]               # after the map build-up
    assert max(cov_steady) > 0.4, covs
    assert min(cov_steady) > 0.5 * max(cov_steady), covs
    w_steady = 2                        # timing: after allocator warm-up
    ms_frame = np.asarray(secs[w_steady:]) * 1e3 / win
    truth = [TruthStats.from_record(r) for rs in wrows[4:] for r in rs]
    # The per-frame path over the same frames, for the steady accuracy
    # of the two paths on the same frames (windows 4 on).
    eng_f = Flame(W, H, cam=VGA, params=params, device=dev)
    truth_f = []
    for i, f in enumerate(frames_b):
        assert eng_f.update(*f, gt_depth=seq_b.depths[i])
        rec = eng_f.flush_stats()
        if i >= 4 * win:
            truth_f.append(TruthStats.from_record(rec))
    # The copy-stream upload changes nothing: with synchronous
    # triangulation, prefetched windows leave the state bit for bit as
    # plain update_window calls do.
    eng_p, eng_q = (Flame(W, H, cam=VGA, params=params, device=dev)
                    for _ in range(2))
    n_cmp = 4 * win
    stream_windows(eng_p, frames_b[:n_cmp], seq_b.depths[:n_cmp], win)
    for w in range(0, n_cmp, win):
        assert eng_q.update_window(frames_b[w:w + win],
                                   seq_b.depths[w:w + win])
    sp, sq = state_to_numpy(eng_p.state), state_to_numpy(eng_q.state)
    differ = [k for k in sp if not np.array_equal(sp[k], sq[k],
                                                  equal_nan=True)]
    assert not differ, f"prefetched != plain in {differ}"
    phase("window_path",
          sync_frames=res_a.frames_processed, sync_wall_s=wall_a,
          sync_mean_rmse=res_a.mean_rmse,
          sync_mean_precision=res_a.mean_precision,
          sync_mean_recall=res_a.mean_recall,
          sync_final_coverage=res_a.final_coverage,
          sync_final_abs_rel=res_a.final_abs_rel,
          sync_final_delta1=res_a.final_delta1, sync_jax_cpu=ref,
          sync_band=band, sync_launches=launches_a, sync_work=work_a,
          stream_frames=n_b, stream_window=win, stream_prefetch_depth=2,
          stream_ms_per_frame_p50=float(np.percentile(ms_frame, 50)),
          stream_ms_per_frame_p95=float(np.percentile(ms_frame, 95)),
          stream_frames_per_s=float(len(ms_frame) * win
                                    / np.sum(secs[w_steady:])),
          stream_coverage_per_window=covs,
          stream_topo_installs=eng_b._topo_installs,
          stream_tri_superseded=eng_b._tri_superseded,
          stream_tri_dropped=eng_b._tri_dropped,
          stream_stale_tri_windows=eng_b._stale_tri_windows,
          stream_pending_at_end=pending_at_end,
          stream_steady_mean_rmse=float(np.nanmean(
              [t.rmse for t in truth])),
          stream_steady_mean_recall=float(np.nanmean(
              [t.recall for t in truth])),
          perframe_steady_mean_rmse=float(np.nanmean(
              [t.rmse for t in truth_f])),
          perframe_steady_mean_recall=float(np.nanmean(
              [t.recall for t in truth_f])),
          prefetch_equals_plain_frames=n_cmp,
          stream_perf_s=eng_b.perf, stream_launches=launches_b,
          stream_work=work_b)

    # 6. small-input agreement: card path vs CPU path --------------------
    cam = Pinhole(105.0, 105.0, 63.5, 47.5, 128, 96)
    small = FlameParams.from_dict({"engine": {"max_features": 256,
                                              "max_keyframes": 4}})
    sseq = make_sequence(10, cam, device="cpu")
    r_gpu = run_offline(synthetic_frames(sseq), cam, small, device=dev)
    r_cpu = run_offline(synthetic_frames(sseq), cam, small, device="cpu")
    assert abs(r_gpu.mean_rmse - r_cpu.mean_rmse) <= 0.15 * r_cpu.mean_rmse
    assert abs(r_gpu.final_coverage - r_cpu.final_coverage) <= 0.05
    phase("small_agreement", rmse_gpu=r_gpu.mean_rmse,
          rmse_cpu=r_cpu.mean_rmse, coverage_gpu=r_gpu.final_coverage,
          coverage_cpu=r_cpu.final_coverage)

    # 7. the live frontend ---------------------------------------------
    live_frontend(seq, recs, res, params, VGA, dev, OUT)

    # 8. tracking mode -------------------------------------------------
    _, ms8 = tracking_path(seq, steady, params, VGA, dev, OUT)

    # 9. tracking mode with windowed bundle adjustment ------------------
    _, node9, stats9 = tracking_ba_path(seq, steady, ms8["clean"], params,
                                        VGA, dev, OUT)

    # 10. many streams ---------------------------------------------------
    batched = multi_stream_path(seq, steady, params, VGA, dev, OUT)

    # 11. viz ------------------------------------------------------------
    viz_path(engine, seq, params, VGA, dev, OUT)

    # 12. many devices ---------------------------------------------------
    multi_device_path(seq, params, VGA, dev, OUT, node9, stats9, smi)

    # 13. the last modules -----------------------------------------------
    last_modules_path(seq, steady, res, params, VGA, dev, OUT, smi)

    # 14. the external-pose acceptance protocol --------------------------
    acceptance_path(dev, OUT, smi, cpu_frames)
    cpu_frames.close()

    # Result lines -----------------------------------------------------
    replaces = {"v4": "flame_ros_tpu/ops/raster_pallas.py:458",
                "v2": "flame_ros_tpu/ops/raster_pallas.py:128",
                "v3": "flame_ros_tpu/ops/raster_pallas.py:288"}
    kernels = []
    for name in names:
        r = rows[name]["engine_density"]   # y-sorted, as the engine's
        kernels.append({
            "name": f"raster_{name}", "route": "cuda",
            "source": "flame_ros_torch/csrc/raster.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    kernels.append({
        "name": "raster_v4_batched", "route": "cuda",
        "source": "flame_ros_torch/csrc/raster.cu",
        "replaces": "flame_ros_tpu/ops/raster_pallas.py:458 (under jax.vmap)",
        "launches": batched["launches"], "max_abs_err": batched["max_err"],
        "ms": batched["ms"], "plain_ms": batched["plain_ms"],
        "bound_ms": batched["bound_ms"], "bound_by": batched["bound_by"],
        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
