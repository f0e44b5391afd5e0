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
   beside the card's name and power limit;
15. the tracking-mode acceptance protocol of
   tests/test_acceptance_tracking.py (TRACK_ACCEPT_RUNS: easy, easy with
   BA, low texture, rotation, rotation with BA, mav, occlusion 80:89 and
   the pod-dense configuration cfg/pod_dense_ba.yaml with BA; VGA, 200
   frames, `--pose-source tracking`) through the port's CLI, four runs
   at a time in four processes on the card (TRACK_PARTS), every frame
   equal bit for bit to the CPU's: 0 failed engine frames, v4 launched
   on every tracked frame and v2 and v3 never, the id buffer after frame
   97 and after a poseframe past the third ring wrap equal to the plain
   v4 version's recomputation (T = 32768 for pod-dense); each run held to
   the JAX package's CPU runs of its frames (track_verdict): up to the
   frame where its runs on frames one float32 step apart part from the
   unmoved run (JAX_TRACK_ACCEPT), each pose no further from the unmoved
   run's than those runs' poses are, plus 1e-4; the first three BA costs
   within 1e-3 relative of those runs' costs; then rmse, recall,
   coverage, ATE, RPE and the solves within phase 8's bands about the
   runs' spread
   (JAX_TRACK_ACCEPT_SPREAD), every gate of the JAX test that the JAX run
   passes passed; pod-dense's solves unsharded, at least 20, each at
   16384 points, and whether the TPU v4's slab budgets would hold there;
   ms/frame p50/p95, `hybrid_bundle_adjust` ms, launches and busy ms a
   call, and v4 timed alone at pod density beside its bound, by the
   card's name and power limit;
16. the streaming acceptance protocol of scripts/chip_acc_streaming.py
   through the port (scripts/chip_acc_streaming_torch.py: windows of 6
   host uint8 frames, prefetch depth 2, deferred Delaunay with
   tri_backpressure="block", the GT stack staged on the card once, at
   most 2 windows in flight, each window's stats read asynchronously)
   over phase 14's default frames, every frame equal to the CPU's: (a)
   the free-running product loop passes the JAX script's six gates (200
   frames evaluated, 0 triangulations dropped, rmse < 0.05, precision >
   0.95, steady recall > 0.70), none failed, every frame healthy, v4
   launched on every frame and v2 and v3 never (wrapper counts and device
   work counters), the id buffer after a poseframe past the third ring
   wrap equal to plain v4's; (b) every stats row read asynchronously
   equal bit for bit to its tensor read after a full synchronize; (c) the
   same frames with the pinned install schedule (every pending Delaunay
   waited for before each window), its launches counted as the free
   run's: where the free run counted no stale window and no superseded
   topology, every stats row and final state leaf equal bit for bit; (d)
   the pinned run within JAX_BAND of the JAX package's pinned run of the
   same frames (JAX_STREAM_ACCEPT; precision 0.02) and within
   STREAM_TIGHT relative, its install count and evaluated frames equal,
   every gate JAX passes passed, and the same run with the filter's
   posterior means rounded to bfloat16 after each window (the tight
   band's control) outside STREAM_TIGHT; fps, latency p50/p95,
   ms/frame, host Delaunay ms per
   poseframe and the install counters of both runs, and steady recall
   beside phase 14's per-frame run, by the card's name and power limit.

Any failure exits non-zero. The line before the last is the card's
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`; before
it, one JSON line of per-kernel numbers (v4's launches: phase 4's and
phase 16's free run's). The last line is the contract
line {"ok": true, "device": {...}}. Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero and
prints no result.
"""
import dataclasses
import functools
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
# The tracking-mode acceptance protocol of tests/test_acceptance_tracking.py:
# VGA, 200 frames, `--pose-source tracking`, default FlameParams but for
# pod_dense. Per run: the `make_sequence` keyword arguments that differ
# from the default sequence, the offline runner's extra arguments, the
# JAX test, and that test's asserts on the runner's summary, quoted as
# gates (a bound (f, key) reads f * summary[key]). pod_dense also spies on
# the BA solves: at least `solves_min`, each at `ba_points` points.
TRACK_ACCEPT_RUNS = {
    "easy": dict(
        seq={}, args=(), test="tests/test_acceptance_tracking.py:60",
        gates=(("frames", "==", 200), ("failed", "==", 0),
               ("ate_rmse", "<", (0.005, "gt_path_length")),
               ("ate_rmse", "<", 0.01), ("idepth_rmse", "<", 0.05),
               ("precision", ">", 0.95), ("recall", ">", 0.82),
               ("rpe_trans_rmse", "<", 0.003),
               ("rpe_rot_rmse_deg", "<", 0.05))),
    "easy_ba": dict(
        seq={}, args=("--ba-refine",),
        test="tests/test_acceptance_tracking.py:79",
        gates=(("frames", "==", 200), ("failed", "==", 0),
               ("ate_rmse", "<", (0.008, "gt_path_length")),
               ("ate_rmse_sim3", "<", 0.01), ("idepth_rmse", "<", 0.05),
               ("recall", ">", 0.82))),
    "low_texture": dict(
        seq=dict(texture_gain=0.3), args=(),
        test="tests/test_acceptance_tracking.py:91",
        gates=(("frames", "==", 200), ("failed", "==", 0),
               ("ate_rmse", "<", (0.01, "gt_path_length")),
               ("idepth_rmse", "<", 0.06), ("recall", ">", 0.85),
               ("rpe_rot_rmse_deg", "<", 0.4))),
    "rotation": dict(
        seq=dict(motion="rotation"), args=(),
        test="tests/test_acceptance_tracking.py:103",
        gates=(("frames", "==", 200), ("failed", "==", 0),
               ("rpe_rot_rmse_deg", "<", 0.03),
               ("rpe30_rot_rmse_deg", "<", 0.5),
               ("rpe_trans_rmse", "<", 0.003), ("ate_rmse_sim3", "<", 0.01),
               ("ate_rmse", "<", 0.03), ("recall", ">", 0.73),
               ("idepth_rmse", "<", 0.06))),
    "rotation_ba": dict(
        seq=dict(motion="rotation"), args=("--ba-refine",),
        test="tests/test_acceptance_tracking.py:124",
        gates=(("frames", "==", 200), ("failed", "==", 0),
               ("rpe_rot_rmse_deg", "<", 0.03),
               ("rpe30_rot_rmse_deg", "<", 0.5),
               ("ate_rmse_sim3", "<", 0.015), ("ate_rmse", "<", 0.03),
               ("recall", ">", 0.75))),
    "mav": dict(
        seq=dict(motion="mav"), args=(),
        test="tests/test_acceptance_tracking.py:138",
        gates=(("frames", "==", 200), ("failed", "==", 0),
               ("ate_rmse", "<", (0.007, "gt_path_length")),
               ("rpe_rot_rmse_deg", "<", 0.05),
               ("rpe_trans_rmse", "<", 0.003), ("recall", ">", 0.70),
               ("idepth_rmse", "<", 0.06))),
    "occlusion": dict(
        seq={}, args=("--occlude", "80:89"),
        test="tests/test_acceptance_tracking.py:152",
        gates=(("track_failed_frames", ">=", 10),
               ("track_failed_frames", "<=", 18),
               ("frames", ">=", 182), ("failed", "==", 0),
               ("ate_rmse", "<", (0.005, "gt_path_length")),
               ("idepth_rmse", "<", 0.05), ("recall", ">", 0.85))),
    "pod_dense": dict(
        seq={}, args=("--ba-refine", "--config", "cfg/pod_dense_ba.yaml"),
        test="tests/test_acceptance_tracking.py:177",
        gates=(("frames", "==", 200), ("failed", "==", 0),
               ("track_failed_frames", "<=", 4), ("ate_rmse", "<", 0.18),
               ("idepth_rmse", "<", 0.15), ("recall", ">", 0.65)),
        solves_min=20, ba_points=16384),
}


# The JAX package on the CPU over the port's rendered frames of each
# TRACK_ACCEPT_RUNS run, unmoved (K = 0) and with a random half of the
# pixels one float32 step up (K = 1..3; rotation_ba and pod_dense
# K = 1..7, easy_ba and rotation K = 1..15), one XLA thread, one CPU
# device (so its BA takes the unsharded route, as the port's on one card):
#   OMP_NUM_THREADS=1 JAX_PLATFORMS=cpu XLA_FLAGS="--xla_cpu_multi_thread_eigen=false \
#       intra_op_parallelism_threads=1" python scripts/jax_tracking_reference.py \
#       --run NAME --perturb 0,1,2,3 > NAME.jsonl
# (further K, and pod_dense's, in processes of their own: --perturb 4,5
# and so on), then
#   python scripts/jax_tracking_reference.py --collect *.jsonl
# JAX_TRACK_ACCEPT is each unmoved run's summary, its first three BA
# costs, its BA route, its parting frame (the first frame at which a
# perturbed run's pose leaves it by more than 1e-4; None: none did) and
# its poses ([img_id, qw, qx, qy, qz, tx, ty, tz, d], d the largest
# distance of a perturbed run's pose from it) before that frame.
# JAX_TRACK_ACCEPT_SPREAD is the smallest and largest value of each metric
# (and of each of the first three BA costs) over the runs. Phase 15
# and tests/test_torch_acceptance_tracking.py hold the port to both
# (track_verdict).
JAX_TRACK_ACCEPT = {
    "easy": {
        "frames": 200,
        "failed": 0,
        "idepth_rmse": 0.02860487670637667,
        "precision": 1.0,
        "recall": 0.854310693359375,
        "coverage": 0.8516764640808105,
        "ate_rmse": 0.004394539662384737,
        "ate_rmse_sim3": 0.0041383467810793585,
        "gt_path_length": 2.643495964324188,
        "rpe_trans_rmse": 0.0005981114888364587,
        "rpe_rot_rmse_deg": 0.010937679725570306,
        "rpe30_trans_rmse": 0.005570244650839392,
        "rpe30_rot_rmse_deg": 0.07936589630828049,
        "track_failed_frames": 0,
        "relocalizations": 0,
        "perturbed": [1, 2, 3],
        "parting_frame": 101,
        "ba_route": {'unsharded': {'solves': 0, 'points': []}, 'sharded': {'solves': 0, 'points': []}},
        "jax_devices": 1,
        "poses": [
            [0, 1, 0, 0, 0, 0, 0, 0, 0],
            [1, 0.99999994, -8.27687472e-06, 0.000755275483, -7.85837801e-06, 0.019152442, 4.75551533e-05, 0.000600933447, 1.04e-07],
            [2, 0.999999464, -8.12580129e-06, 0.00156834931, -1.7059956e-05, 0.0378730111, 0.000304372632, 0.00138348714, 4.03e-08],
            [3, 0.999998987, -6.86746216e-06, 0.00230144686, -1.61922908e-05, 0.0571339875, 0.000736193557, 0.00183815463, 7.82e-08],
            [4, 0.999998987, -4.00727804e-05, 0.00313823391, -5.10179962e-05, 0.0756388158, 0.00109161437, 0.00255503971, 5.96e-08],
            [5, 1.00000143, -2.04989447e-05, 0.00390937831, -4.45743281e-05, 0.0944528729, 0.00201592711, 0.0033393479, 7.29e-08],
            [6, 1.00001109, -1.7966644e-05, 0.00467414828, -3.31264782e-05, 0.113268547, 0.00305753225, 0.00380603038, 1.64e-07],
            [7, 1.00003791, -1.76307731e-05, 0.00545943761, -3.28533388e-05, 0.131668001, 0.00419698888, 0.00428148033, 2.98e-08],
            [8, 1.0000335, -1.49820744e-05, 0.0061965026, -1.85847584e-05, 0.150231868, 0.00568229798, 0.00449499208, 2.84e-07],
            [9, 1.00002885, -3.36751577e-06, 0.00691233249, -2.0238469e-05, 0.168784916, 0.00713743456, 0.00520266313, 1.98e-07],
            [10, 1.00002372, 6.5501692e-05, 0.00762453722, -2.41089947e-06, 0.187124819, 0.00936253741, 0.00581489597, 1.22e-07],
            [11, 1.00001836, 7.53114e-05, 0.00828711223, 3.69779445e-06, 0.205542237, 0.0113258325, 0.0064281188, 2.23e-07],
            [12, 1.00001121, 3.55017582e-05, 0.0090747457, -1.02448448e-05, 0.222940043, 0.0130478386, 0.00668707397, 3.17e-07],
            [13, 1.0000031, -7.74539876e-06, 0.00990559347, -2.4537072e-05, 0.239880815, 0.0149277747, 0.00661520846, 2.76e-07],
            [14, 0.99999392, -3.37218953e-05, 0.0107932538, -5.90250202e-05, 0.256243765, 0.0171135142, 0.00658704108, 1.51e-07],
            [15, 0.999985933, -8.48775962e-05, 0.0115087926, -4.18134769e-05, 0.273171842, 0.0192892347, 0.00673738495, 3.46e-07],
            [16, 0.999978185, -7.59197937e-05, 0.0121926721, -8.75800833e-05, 0.290097058, 0.0219596885, 0.00711824372, 2.75e-07],
            [17, 0.999969661, -0.000136183138, 0.012896955, -0.000111631518, 0.30632472, 0.0244266316, 0.00707619078, 3.28e-07],
            [18, 0.999961078, -0.000155400223, 0.0136041036, -8.94899131e-05, 0.32224077, 0.0272704307, 0.00743435696, 2.33e-07],
            [19, 0.99995482, -8.42023073e-05, 0.0142200384, -0.000123400299, 0.338282347, 0.0307930652, 0.00782761071, 2.24e-07],
            [20, 0.999947011, -9.79757751e-05, 0.0147496052, -0.000119575576, 0.354384989, 0.033878874, 0.00816829503, 4.27e-07],
            [21, 0.99993521, -0.000179699258, 0.015512282, -0.000179411814, 0.368622601, 0.0368352756, 0.00846952852, 4.15e-07],
            [22, 0.999924839, -0.000145209036, 0.0161323026, -0.000147400307, 0.383356482, 0.0407023653, 0.00851373281, 3.56e-07],
            [23, 0.999914467, -4.68759972e-05, 0.0166772138, -0.000161960998, 0.39823243, 0.0449720733, 0.0087598972, 3.59e-07],
            [24, 0.999901116, -0.00015757051, 0.0172636863, -0.000168687271, 0.412172318, 0.0480696633, 0.00897955056, 3.41e-07],
            [25, 0.999882519, -0.000132583431, 0.0178640299, -0.000154327689, 0.425510824, 0.052190505, 0.00914909504, 5.31e-07],
            [26, 0.999871075, -0.00010125251, 0.018492328, -0.000149845466, 0.43814978, 0.0563875325, 0.00939934235, 7.11e-07],
            [27, 0.999861956, -0.000197810441, 0.0189852491, -0.000191375104, 0.451119602, 0.059998855, 0.00937347952, 5.24e-07],
            [28, 0.999851167, -0.000183218173, 0.0195555873, -0.000207782956, 0.462939471, 0.0643910915, 0.00985810906, 5.12e-07],
            [29, 0.999842644, -0.000224062562, 0.0200021621, -0.000206410681, 0.47514984, 0.0685566589, 0.00977495592, 6.68e-07],
            [30, 0.999834061, -0.000222671748, 0.0204722155, -0.000203443822, 0.486479163, 0.0731175765, 0.0100599863, 5.91e-07],
            [31, 0.999826968, -0.000197064452, 0.020917654, -0.000191328436, 0.497366726, 0.0780020282, 0.0101206396, 6.12e-07],
            [32, 0.999817789, -0.000147851635, 0.0213539563, -0.000155836635, 0.507714212, 0.0830498934, 0.0105044665, 6.1e-07],
            [33, 0.999808252, -0.000202572512, 0.0217884686, -0.000173103006, 0.517343462, 0.0875065029, 0.0106325056, 6.69e-07],
            [34, 0.99980098, -0.000209975304, 0.0221064147, -0.000191244719, 0.527142704, 0.0923559889, 0.0107830605, 8.52e-07],
            [35, 0.999791205, -0.000295523496, 0.0225130059, -0.000208151265, 0.535658717, 0.0968529508, 0.0108812563, 7.08e-07],
            [36, 0.999782264, -0.00035536103, 0.0228276141, -0.000219947484, 0.54417026, 0.101528928, 0.011246697, 7.93e-07],
            [37, 0.999770224, -0.000281010638, 0.0231860373, -0.00020725916, 0.551705301, 0.107247047, 0.0116963657, 7.12e-07],
            [38, 0.999764264, -0.00030051131, 0.0234474465, -0.00021047768, 0.559169531, 0.112343952, 0.011798935, 8.05e-07],
            [39, 0.999758005, -0.000275858358, 0.0237117056, -0.000200884286, 0.565825284, 0.117763646, 0.012549689, 7.39e-07],
            [40, 0.999751389, -0.000327524205, 0.0239954758, -0.000249023928, 0.571627736, 0.122811735, 0.012701205, 7.53e-07],
            [41, 0.999747634, -0.000311497657, 0.0241700355, -0.000217087087, 0.577478886, 0.128391832, 0.0133655546, 8.52e-07],
            [42, 0.999742031, -0.000301623892, 0.0244374909, -0.0002226941, 0.582030356, 0.133953989, 0.0135223251, 7.9e-07],
            [43, 0.999739528, -0.000329883216, 0.0246386472, -0.000240798734, 0.586273372, 0.139258951, 0.0138008967, 8.25e-07],
            [44, 0.999736488, -0.000386677915, 0.024756005, -0.000282459019, 0.590241015, 0.144515336, 0.014075892, 8.79e-07],
            [45, 0.999731243, -0.000398981851, 0.0249709934, -0.000312034914, 0.592916787, 0.150000483, 0.0147377225, 8.37e-07],
            [46, 0.999729395, -0.000319015613, 0.0250339992, -0.000283674221, 0.595628142, 0.156211019, 0.0156325959, 8.85e-07],
            [47, 0.999726534, -0.000377921155, 0.0251347255, -0.000317035709, 0.597620606, 0.161467493, 0.0152536687, 7.58e-07],
            [48, 0.999724925, -0.00030338479, 0.0251580831, -0.000266453746, 0.599154711, 0.167534038, 0.016722681, 8.87e-07],
            [49, 0.99972254, -0.000305036752, 0.0251587741, -0.000261836918, 0.60002476, 0.173283428, 0.0175580643, 7.9e-07],
            [50, 0.999722004, -0.000309409632, 0.0251802262, -0.0002834404, 0.600178421, 0.179137141, 0.0184519365, 8.88e-07],
            [51, 0.999721467, -0.00037157652, 0.0252063833, -0.000277894258, 0.599380374, 0.184400082, 0.0192316677, 7.92e-07],
            [52, 0.999724388, -0.000268787117, 0.025093684, -0.000291224802, 0.598635793, 0.190773085, 0.0200240463, 7.15e-07],
            [53, 0.99972713, -0.000224256757, 0.0250004698, -0.000303813606, 0.597305536, 0.196672484, 0.0206807479, 9.39e-07],
            [54, 0.999728858, -0.000283114146, 0.0249636658, -0.000272158184, 0.594737172, 0.201986089, 0.0215327814, 7.15e-07],
            [55, 0.999735177, -0.000282251305, 0.024804553, -0.000241779897, 0.591994226, 0.207626402, 0.0228348654, 1.1e-06],
            [56, 0.999740005, -0.000288369047, 0.0246104393, -0.000216190485, 0.588796735, 0.213368639, 0.0239180103, 1.23e-06],
            [57, 0.999741495, -0.000323462591, 0.0245500002, -0.000222125949, 0.584104896, 0.218635038, 0.0245892685, 1.59e-06],
            [58, 0.999746919, -0.000306333764, 0.0243281014, -0.000223287978, 0.579751432, 0.224236593, 0.025489362, 2.21e-06],
            [59, 0.999753058, -0.000248682249, 0.0240935478, -0.000233797706, 0.57477212, 0.230135441, 0.02660124, 2.67e-06],
            [60, 0.999759793, -0.000326696376, 0.0238304939, -0.000223608396, 0.56907618, 0.235116959, 0.027420748, 2.44e-06],
            [61, 0.999766886, -0.000343660184, 0.0236023683, -0.000222445844, 0.562508404, 0.240351856, 0.0285560545, 3.28e-06],
            [62, 0.999774754, -0.000319841725, 0.0232644528, -0.00019343711, 0.555794418, 0.245903179, 0.0297389943, 3.8e-06],
            [63, 0.999781549, -0.000377232936, 0.0229772106, -0.000188068938, 0.548051, 0.250782639, 0.0307535008, 4.47e-06],
            [64, 0.999790251, -0.000372593116, 0.0226028282, -0.000181533833, 0.540350795, 0.255861789, 0.0318553783, 4.89e-06],
            [65, 0.999799609, -0.000338947022, 0.0222065505, -0.00019311544, 0.532199144, 0.261190265, 0.0329465233, 6.2e-06],
            [66, 0.999808252, -0.000378400291, 0.0218541604, -0.000212664207, 0.522789776, 0.266137093, 0.0343882963, 7.69e-06],
            [67, 0.999819219, -0.000344827888, 0.0214667916, -0.000192439489, 0.513055146, 0.271264642, 0.0356066152, 9.72e-06],
            [68, 0.999830365, -0.000321600062, 0.0209488459, -0.000177091148, 0.503443539, 0.276332825, 0.0366346389, 1.16e-05],
            [69, 0.999839544, -0.000287927949, 0.0205146875, -0.000129201813, 0.492786139, 0.281322449, 0.038083896, 2.03e-05],
            [70, 0.999848247, -0.000268447446, 0.020103408, -0.000153370958, 0.481176108, 0.286091447, 0.0392913297, 1.06e-05],
            [71, 0.999859154, -0.000271619909, 0.0196075272, -0.000173301902, 0.469730824, 0.290622532, 0.0404706672, 1.27e-05],
            [72, 0.999871194, -0.000326854934, 0.019105874, -0.000195893779, 0.457646459, 0.294727236, 0.0417306274, 1.12e-05],
            [73, 0.999888599, -0.00034590991, 0.0185018107, -0.000164986501, 0.445589334, 0.2989856, 0.0430280752, 1.64e-05],
            [74, 0.999900877, -0.000337945356, 0.0178302247, -0.000125103747, 0.433295369, 0.303321004, 0.0446537547, 1.27e-05],
            [75, 0.999909937, -0.000407759071, 0.0173236337, -0.000135893191, 0.419490159, 0.30702737, 0.0457957722, 1.53e-05],
            [76, 0.999920249, -0.000299403298, 0.0167399626, -0.000162989672, 0.405627221, 0.311522484, 0.047189597, 2.02e-05],
            [77, 0.999931514, -0.000348423782, 0.0161023159, -0.00010754395, 0.391615152, 0.315046847, 0.048332639, 4.6e-05],
            [78, 0.99994272, -0.000369140878, 0.0155070005, -0.000129827647, 0.376829743, 0.318715364, 0.0496440232, 2.16e-05],
            [79, 0.999957144, -0.000289745047, 0.0148864407, -0.000126175786, 0.361678213, 0.322667986, 0.0508891381, 1.4e-05],
            [80, 0.999967337, -0.000326748064, 0.0141887087, -9.33239498e-05, 0.346401334, 0.325814515, 0.0521353558, 1.54e-05],
            [81, 0.999976635, -0.000322982291, 0.0135379853, -0.000110776935, 0.33057797, 0.329136997, 0.0532651916, 1.82e-05],
            [82, 0.999986172, -0.000308882387, 0.0128429001, -6.46112894e-05, 0.314665407, 0.332345754, 0.0543103889, 1.71e-05],
            [83, 0.99999541, -0.000311685813, 0.0122086257, -0.000113914357, 0.29789418, 0.335259616, 0.0557472296, 1.51e-05],
            [84, 1.00000608, -0.000304006098, 0.0115360674, -6.27105837e-05, 0.281022042, 0.337981492, 0.0567064844, 2.22e-05],
            [85, 1.00002182, -0.000296255341, 0.010710557, -8.51605e-05, 0.264692515, 0.34075129, 0.0581995286, 2.63e-05],
            [86, 1.00002897, -0.000327768095, 0.0100149466, -7.92177743e-05, 0.247192264, 0.343053609, 0.0592940152, 3.05e-05],
            [87, 1.00003624, -0.000253652222, 0.00929720793, -4.4847995e-05, 0.229527697, 0.345736772, 0.0604075789, 3.35e-05],
            [88, 1.00004375, -0.000302123575, 0.0084911976, -8.60587825e-05, 0.212060049, 0.347652644, 0.0615296066, 3.69e-05],
            [89, 1.00005043, -0.00032205641, 0.0077815135, -5.71892779e-05, 0.193904549, 0.349485248, 0.0624838471, 3.2e-05],
            [90, 1.00005889, -0.000278782885, 0.00694917422, -3.90888599e-05, 0.176206753, 0.351501822, 0.0635323599, 3.92e-05],
            [91, 1.00006878, -0.000322809501, 0.00627334276, -6.75388583e-05, 0.157360464, 0.352837145, 0.0642964542, 4.28e-05],
            [92, 1.00007463, -0.00031041287, 0.00529000489, -6.47179186e-05, 0.139757097, 0.354536504, 0.0655529201, 4.82e-05],
            [93, 1.00007761, -0.000358019635, 0.00472675543, -9.09763694e-05, 0.119980618, 0.35537672, 0.0659250319, 5.54e-05],
            [94, 1.00008178, -0.00033902115, 0.00385106867, -7.55292276e-05, 0.101597577, 0.356451571, 0.0670226812, 6.32e-05],
            [95, 1.00008607, -0.000284805923, 0.00292322598, -3.67178181e-05, 0.083560437, 0.357711256, 0.0682194382, 6.81e-05],
            [96, 1.00009084, -0.000298876199, 0.00216674781, -4.53583634e-05, 0.0643021613, 0.358351648, 0.0689692721, 8.41e-05],
            [97, 1.00009906, -0.000303607987, 0.00136488641, -5.36319967e-05, 0.0452753156, 0.358882457, 0.0697947517, 8.3e-05],
            [98, 1.00010014, -0.000276699342, 0.000327388581, -3.23357017e-05, 0.0273851901, 0.359426737, 0.0709651634, 8.35e-05],
            [99, 1.00010002, -0.000258253189, -0.000477120513, -2.44932289e-05, 0.00815790892, 0.359705776, 0.0718068779, 8.63e-05],
            [100, 1.00009966, -0.000247100892, -0.00135183695, -3.1182004e-05, -0.0104938336, 0.359762162, 0.0725869313, 9.36e-05],
        ],
    },
    "easy_ba": {
        "frames": 200,
        "failed": 0,
        "idepth_rmse": 0.02973144467920065,
        "precision": 1.0,
        "recall": 0.8624308430989583,
        "coverage": 0.8713281750679016,
        "ate_rmse": 0.009011904762511165,
        "ate_rmse_sim3": 0.002703305207520242,
        "gt_path_length": 2.643495964324188,
        "rpe_trans_rmse": 0.0006210389508658578,
        "rpe_rot_rmse_deg": 0.011570308104616815,
        "rpe30_trans_rmse": 0.007292582646618685,
        "rpe30_rot_rmse_deg": 0.07832329166830793,
        "track_failed_frames": 0,
        "relocalizations": 0,
        "ba_solves": 25,
        "perturbed": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
        "parting_frame": 30,
        "ba_route": {'unsharded': {'solves': 25, 'points': [256]}, 'sharded': {'solves': 0, 'points': []}},
        "jax_devices": 1,
        "ba_costs": [2.8223657608032227, 2.3683857917785645, 2.762031078338623],
        "poses": [
            [0, 1, 0, 0, 0, 0, 0, 0, 0],
            [1, 0.99999994, -8.27687472e-06, 0.000755275483, -7.85837801e-06, 0.019152442, 4.75551533e-05, 0.000600933447, 1.04e-07],
            [2, 0.999999464, -8.12580129e-06, 0.00156834931, -1.7059956e-05, 0.0378730111, 0.000304372632, 0.00138348714, 6.41e-08],
            [3, 0.999998987, -6.86746216e-06, 0.00230144686, -1.61922908e-05, 0.0571339875, 0.000736193557, 0.00183815463, 9.31e-08],
            [4, 0.999998987, -4.00727804e-05, 0.00313823391, -5.10179962e-05, 0.0756388158, 0.00109161437, 0.00255503971, 1.64e-07],
            [5, 1.00000143, -2.04989447e-05, 0.00390937831, -4.45743281e-05, 0.0944528729, 0.00201592711, 0.0033393479, 9.59e-08],
            [6, 1.00001109, -1.7966644e-05, 0.00467414828, -3.31264782e-05, 0.113268547, 0.00305753225, 0.00380603038, 1.64e-07],
            [7, 1.00003791, -1.76307731e-05, 0.00545943761, -3.28533388e-05, 0.131668001, 0.00419698888, 0.00428148033, 1.3e-07],
            [8, 1.0000335, -1.49820744e-05, 0.0061965026, -1.85847584e-05, 0.150231868, 0.00568229798, 0.00449499208, 2.84e-07],
            [9, 1.00002885, -3.36751577e-06, 0.00691233249, -2.0238469e-05, 0.168784916, 0.00713743456, 0.00520266313, 3.54e-07],
            [10, 1.00002372, 6.5501692e-05, 0.00762453722, -2.41089947e-06, 0.187124819, 0.00936253741, 0.00581489597, 2.83e-07],
            [11, 1.00001836, 7.53114e-05, 0.00828711223, 3.69779445e-06, 0.205542237, 0.0113258325, 0.0064281188, 2.38e-07],
            [12, 1.00001121, 3.55017582e-05, 0.0090747457, -1.02448448e-05, 0.222940043, 0.0130478386, 0.00668707397, 5.97e-07],
            [13, 1.0000031, -7.74539876e-06, 0.00990559347, -2.4537072e-05, 0.239880815, 0.0149277747, 0.00661520846, 1.25e-06],
            [14, 0.999994338, -1.64429748e-05, 0.0107539259, -6.04476372e-05, 0.256317943, 0.017202504, 0.00662308838, 1.27e-06],
            [15, 0.999986708, -8.15681851e-05, 0.0114503317, -4.81706084e-05, 0.273204088, 0.0192751046, 0.00671277288, 1.23e-06],
            [16, 0.9999789, -0.000109715191, 0.0121309869, -0.000107580236, 0.289986968, 0.0216528233, 0.00700485194, 1.37e-06],
            [17, 0.999971449, -0.000106375694, 0.0127674472, -0.000121847013, 0.306477219, 0.0245295987, 0.00705492822, 1.77e-06],
            [18, 0.999964356, -3.57238823e-05, 0.0134007977, -0.000101407073, 0.322682142, 0.0279395059, 0.00760976085, 1.77e-06],
            [19, 0.999958277, -5.38758904e-05, 0.0140533112, -0.000140517295, 0.338346958, 0.030838212, 0.00777193811, 9.54e-07],
            [20, 0.999950469, -5.78472209e-05, 0.0145842414, -0.000129012289, 0.354290098, 0.033973448, 0.00811929163, 2.59e-06],
            [21, 0.999939382, -6.72951501e-05, 0.0153109711, -0.000176122208, 0.368640333, 0.0373859145, 0.0086859623, 4.01e-06],
            [22, 0.999930203, 3.8967697e-05, 0.015868064, -0.000119167707, 0.383660585, 0.0417202488, 0.00894613378, 5.8e-06],
            [23, 0.999919474, 0.000101284895, 0.0164395031, -0.000133416514, 0.398169398, 0.0457404889, 0.00927615445, 8.16e-06],
            [24, 0.99990654, 1.95448265e-05, 0.0170324165, -0.000133547452, 0.411985338, 0.0490590781, 0.00938178971, 1.84e-05],
            [25, 0.999888778, 6.7901412e-05, 0.0176035017, -0.000115030853, 0.425467312, 0.053307496, 0.00976206269, 2.31e-05],
            [26, 0.999876738, 9.79441975e-05, 0.0182701461, -9.18714431e-05, 0.437933147, 0.0575537011, 0.0101495488, 3.91e-05],
            [27, 0.999867976, -1.91246017e-05, 0.0187589973, -0.000125029735, 0.451010227, 0.0610406138, 0.0102846893, 9.94e-05],
            [28, 0.999857306, 8.78543233e-06, 0.0193393994, -0.000115448493, 0.462850958, 0.0656030774, 0.010940494, 9.92e-05],
            [29, 0.99984926, -1.13452743e-05, 0.0197922066, -0.000104532039, 0.475103557, 0.0699971467, 0.0110064335, 7.52e-05],
        ],
    },
    "low_texture": {
        "frames": 200,
        "failed": 0,
        "idepth_rmse": 0.03290954616852105,
        "precision": 1.0,
        "recall": 0.8680556803385415,
        "coverage": 0.8478613495826721,
        "ate_rmse": 0.006408520692473594,
        "ate_rmse_sim3": 0.005997113906543451,
        "gt_path_length": 2.643495964324188,
        "rpe_trans_rmse": 0.0030642440015333683,
        "rpe_rot_rmse_deg": 0.060379982719267436,
        "rpe30_trans_rmse": 0.007236958809567767,
        "rpe30_rot_rmse_deg": 0.12799411741045252,
        "track_failed_frames": 0,
        "relocalizations": 0,
        "perturbed": [1, 2, 3],
        "parting_frame": 17,
        "ba_route": {'unsharded': {'solves': 0, 'points': []}, 'sharded': {'solves': 0, 'points': []}},
        "jax_devices": 1,
        "poses": [
            [0, 1, 0, 0, 0, 0, 0, 0, 0],
            [1, 1.00000024, 7.53410786e-05, 0.000589677249, 4.86439094e-05, 0.0200580414, 0.000530653459, -0.000665596162, 2.63e-06],
            [2, 0.999999523, 2.60035358e-05, 0.00163023791, -6.71140442e-05, 0.0374239683, 0.000395241135, 0.00061152922, 2.02e-05],
            [3, 0.999999523, -4.28133571e-05, 0.00230047316, -3.28460628e-05, 0.0570937842, 0.00043361081, 0.00131260231, 2.65e-06],
            [4, 0.999999166, -0.000113528906, 0.00330520212, -8.43343951e-05, 0.0746108294, 0.000606694026, 0.00165894919, 9.62e-07],
            [5, 1.00000346, -4.33708301e-05, 0.00395571394, -8.75150145e-05, 0.0941439718, 0.00180828385, 0.00278778886, 2.73e-06],
            [6, 1.00001633, -1.65594138e-05, 0.00473732082, -6.52545496e-05, 0.112941615, 0.00302453036, 0.00332586677, 5.96e-07],
            [7, 1.00005138, -4.84098337e-06, 0.00552065251, -6.71998714e-05, 0.131262705, 0.00422317395, 0.00391173735, 1.43e-06],
            [8, 1.00004768, -0.000128928586, 0.00609336421, -2.44860676e-05, 0.150417477, 0.00493880361, 0.0031295158, 1.43e-06],
            [9, 1.00004256, -4.50150183e-05, 0.00690306257, -1.46291277e-05, 0.168672994, 0.00694618002, 0.00520341843, 1.43e-06],
            [10, 1.00003648, -6.65616972e-05, 0.00769716175, -2.27171404e-06, 0.186450779, 0.00847754162, 0.00554617029, 1.43e-06],
            [11, 1.00002956, -8.37055122e-05, 0.00849787518, -1.58927141e-05, 0.203830093, 0.0102972416, 0.00536090136, 5.9e-06],
            [12, 1.00002205, -0.000160761658, 0.00919360761, 6.26630936e-06, 0.221944571, 0.01174495, 0.00604236033, 7.93e-06],
            [13, 1.0000118, -6.75196643e-05, 0.00991644058, -1.26709419e-05, 0.239472181, 0.0146663133, 0.0060876254, 6.68e-06],
            [14, 0.999999642, -0.000216401386, 0.011093894, -7.5225631e-05, 0.254209369, 0.01608021, 0.00534155779, 4.8e-05],
            [15, 0.999992311, -0.000243428163, 0.0117606428, -4.23986385e-05, 0.271462291, 0.0183874499, 0.00587152829, 1.35e-05],
            [16, 0.999984801, -0.000382547907, 0.0124449944, -8.51971781e-05, 0.288419724, 0.02007965, 0.00600683782, 2.4e-05],
        ],
    },
    "rotation": {
        "frames": 200,
        "failed": 0,
        "idepth_rmse": 0.03698219157755375,
        "precision": 1.0,
        "recall": 0.7803816080729166,
        "coverage": 0.7475293278694153,
        "ate_rmse": 0.009566661755867992,
        "ate_rmse_sim3": 0.002628476717384667,
        "gt_path_length": 0.267369855260486,
        "rpe_trans_rmse": 0.0005255694137033502,
        "rpe_rot_rmse_deg": 0.009508992960587161,
        "rpe30_trans_rmse": 0.00879663285201925,
        "rpe30_rot_rmse_deg": 0.1643565216707609,
        "track_failed_frames": 0,
        "relocalizations": 0,
        "perturbed": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
        "parting_frame": 55,
        "ba_route": {'unsharded': {'solves': 0, 'points': []}, 'sharded': {'solves': 0, 'points': []}},
        "jax_devices": 1,
        "poses": [
            [0, 1, 0, 0, 0, 0, 0, 0, 0],
            [1, 0.999987245, 0.0018953667, 0.00467444398, -3.09017087e-05, 0.00219098455, -4.61087875e-05, -0.000147295141, 1.19e-07],
            [2, 0.999948084, 0.00368789397, 0.00949861296, -6.32390365e-05, 0.00356484344, -0.000590435171, -0.000311801123, 1.84e-07],
            [3, 0.999883533, 0.00561989052, 0.0141891278, -4.0590985e-05, 0.0056488011, -0.000178767557, -0.00032726361, 1.88e-07],
            [4, 0.999793649, 0.00747302268, 0.01889023, -4.26246697e-05, 0.00758709479, 8.59357988e-06, -0.000330156065, 2.14e-07],
            [5, 0.999679267, 0.00929496717, 0.0235723071, -6.89102162e-05, 0.00950131379, 2.23551342e-05, -0.000486146571, 1.3e-07],
            [6, 0.999539495, 0.011130604, 0.0282570366, -3.78381374e-05, 0.0111911623, 0.000488853606, -0.000583190529, 2.98e-07],
            [7, 0.999379575, 0.0127867889, 0.0328814238, -3.44010878e-05, 0.0130923456, 0.000176029323, -0.000778878748, 7.15e-07],
            [8, 0.99919498, 0.0143772643, 0.0375115722, -6.7219742e-05, 0.014728386, -0.000294563535, -0.00108387624, 7.15e-07],
            [9, 0.998986661, 0.0160146896, 0.0421216339, -5.26641343e-05, 0.016241923, -3.53275973e-05, -0.00114244339, 7.15e-07],
            [10, 0.998757541, 0.017587956, 0.0466925986, -6.79668592e-05, 0.0177780986, 0.000173874418, -0.00131367147, 7.15e-07],
            [11, 0.998514473, 0.0189963561, 0.0511530377, -8.70076619e-05, 0.0196201019, -0.000115046845, -0.00157396449, 8.34e-07],
            [12, 0.998249054, 0.0204265695, 0.0556467287, -8.89906514e-05, 0.0209249854, 0.000206108263, -0.0019777182, 8.94e-07],
            [13, 0.997973442, 0.0217170287, 0.0600628927, -8.87640708e-05, 0.0223829933, 0.000146623745, -0.0019917693, 1.19e-06],
            [14, 0.99767375, 0.0230231211, 0.064397186, -7.91653074e-05, 0.0238590408, 0.000778700109, -0.00195396878, 1.19e-06],
            [15, 0.997362971, 0.024106469, 0.0686730072, -0.000112800626, 0.0252887793, 0.000636068464, -0.0024636318, 1.19e-06],
            [16, 0.997042596, 0.0250103958, 0.0728725791, -0.000117553376, 0.0267011318, -1.19372853e-05, -0.0027750507, 1.13e-06],
            [17, 0.996711552, 0.0259789731, 0.0769477189, -0.000122496043, 0.0284748841, 0.000346579938, -0.00295419712, 1.07e-06],
            [18, 0.996368766, 0.0268108808, 0.0809942782, -0.000135220675, 0.0299289636, 0.000547495612, -0.00318998937, 9.54e-07],
            [19, 0.99601084, 0.0275805593, 0.0850301981, -0.000143193203, 0.030819755, 0.00114503782, -0.00336597161, 1.97e-06],
            [20, 0.995656013, 0.0281550083, 0.0889106467, -0.000159552583, 0.0322240368, 0.00109589519, -0.00374523643, 2.02e-06],
            [21, 0.995285809, 0.0286356881, 0.0928184167, -0.00016950295, 0.0326659605, 0.00126113917, -0.00396992499, 2.81e-06],
            [22, 0.994941652, 0.0289271902, 0.09635593, -0.000166624799, 0.0349646397, 0.00104881369, -0.00450118771, 7.02e-06],
            [23, 0.994572997, 0.0292559341, 0.100007884, -0.000187340862, 0.0358884484, 0.00178896182, -0.00482026814, 7.79e-06],
            [24, 0.994216263, 0.0293359458, 0.103501767, -0.000179849652, 0.0370254181, 0.00162335369, -0.00520185288, 9.77e-06],
            [25, 0.993861139, 0.0293406639, 0.106929131, -0.000194451641, 0.0379961096, 0.00181000074, -0.00544930901, 1.48e-05],
            [26, 0.993508935, 0.0291477665, 0.110207826, -0.000191460669, 0.0391112641, 0.00152656739, -0.00604501832, 1.47e-05],
            [27, 0.99315244, 0.0288736634, 0.113444865, -0.000221604205, 0.0398162082, 0.00149457762, -0.0063460907, 1.47e-05],
            [28, 0.992815256, 0.0286113471, 0.116430148, -0.000221935639, 0.0413843766, 0.00231697364, -0.00682735257, 1.44e-05],
            [29, 0.992474616, 0.028099142, 0.119430922, -0.00023994052, 0.0420126207, 0.00219564326, -0.00689008879, 1.39e-05],
            [30, 0.992152154, 0.0275352746, 0.122236378, -0.000240160414, 0.0430538021, 0.00261912774, -0.00739588123, 1.48e-05],
            [31, 0.991833389, 0.0269091167, 0.124991484, -0.000263503287, 0.0437082425, 0.0033422797, -0.00735144643, 1.95e-05],
            [32, 0.991520584, 0.0260756463, 0.127622634, -0.000266656367, 0.044194635, 0.00341420225, -0.00782878324, 1.94e-05],
            [33, 0.991221547, 0.0251433123, 0.130107597, -0.000278818596, 0.0448405109, 0.00359289744, -0.00784314517, 1.93e-05],
            [34, 0.990944564, 0.0241662972, 0.13238278, -0.000270402175, 0.0458745174, 0.00419218605, -0.00826422684, 1.87e-05],
            [35, 0.990675688, 0.0230840184, 0.134569213, -0.000295887323, 0.0467413664, 0.00471331878, -0.00846273173, 1.79e-05],
            [36, 0.990407169, 0.0218202062, 0.136736602, -0.000284237205, 0.0465517379, 0.00475683855, -0.00881962571, 1.59e-05],
            [37, 0.990185678, 0.0205252711, 0.138527155, -0.000306189177, 0.0480818152, 0.0050533805, -0.00933942199, 1.55e-05],
            [38, 0.989971399, 0.0192100052, 0.140238032, -0.000318105915, 0.0490652956, 0.00587427197, -0.00984256528, 1.54e-05],
            [39, 0.989760041, 0.0177203715, 0.141914845, -0.000335187797, 0.0493930355, 0.00613841787, -0.0101229204, 1.68e-05],
            [40, 0.989561439, 0.016229324, 0.14347209, -0.000297771272, 0.0495365188, 0.00681910058, -0.0100339828, 2.35e-05],
            [41, 0.989396811, 0.0146847228, 0.144774809, -0.000320891268, 0.0503251068, 0.00764923636, -0.0104393009, 1.6e-05],
            [42, 0.989241004, 0.0129655367, 0.146012127, -0.000332964672, 0.0506669879, 0.00769940671, -0.0105650863, 1.69e-05],
            [43, 0.989112616, 0.011247375, 0.147053629, -0.000329414266, 0.0512534082, 0.0081385728, -0.0107752522, 1.88e-05],
            [44, 0.988990664, 0.00951989926, 0.147993132, -0.000359556259, 0.0516156219, 0.00884725805, -0.0107497377, 3.45e-05],
            [45, 0.988892794, 0.00768542662, 0.148751676, -0.000360242615, 0.0519368015, 0.00916486513, -0.0110416897, 2.17e-05],
            [46, 0.988809049, 0.00582014723, 0.149391577, -0.000348120171, 0.0520486608, 0.00948550832, -0.011228201, 5.5e-05],
            [47, 0.988744676, 0.00395841943, 0.149880841, -0.000336624624, 0.0521640368, 0.00998092815, -0.0114082471, 6.23e-05],
            [48, 0.988702953, 0.00206687301, 0.150197819, -0.000327646238, 0.0524359308, 0.0103607699, -0.0114103705, 2.73e-05],
            [49, 0.988675117, 0.000158016803, 0.150406852, -0.000343866384, 0.0523541383, 0.0108372327, -0.0116529465, 5.2e-05],
            [50, 0.988671541, -0.00175065536, 0.150420383, -0.000361472339, 0.0525231622, 0.0113633303, -0.0119562894, 5.12e-05],
            [51, 0.988681555, -0.00370960333, 0.150320113, -0.000336501835, 0.0523505807, 0.0113527654, -0.0119032832, 4.9e-05],
            [52, 0.988711894, -0.00558530446, 0.150061503, -0.000342004147, 0.0522223786, 0.0119870063, -0.0119563332, 4.9e-05],
            [53, 0.988761485, -0.00746520655, 0.149654433, -0.000375083328, 0.0521422885, 0.0124559458, -0.0119779548, 4.83e-05],
            [54, 0.98883301, -0.00930221286, 0.149081692, -0.00035946077, 0.0520123355, 0.0130990725, -0.0119795324, 4.91e-05],
        ],
    },
    "rotation_ba": {
        "frames": 200,
        "failed": 0,
        "idepth_rmse": 0.0434986669011414,
        "precision": 1.0,
        "recall": 0.7848537272135416,
        "coverage": 0.7197005152702332,
        "ate_rmse": 0.009768523641582125,
        "ate_rmse_sim3": 0.0035191233129037744,
        "gt_path_length": 0.267369855260486,
        "rpe_trans_rmse": 0.0005439739691928703,
        "rpe_rot_rmse_deg": 0.010086369637522359,
        "rpe30_trans_rmse": 0.009438929441194798,
        "rpe30_rot_rmse_deg": 0.19676545203993606,
        "track_failed_frames": 0,
        "relocalizations": 0,
        "ba_solves": 25,
        "perturbed": [1, 2, 3, 4, 5, 6, 7],
        "parting_frame": 66,
        "ba_route": {'unsharded': {'solves': 25, 'points': [256]}, 'sharded': {'solves': 0, 'points': []}},
        "jax_devices": 1,
        "ba_costs": [1.62749183177948, 1.6092332601547241, 2.229059934616089],
        "poses": [
            [0, 1, 0, 0, 0, 0, 0, 0, 0],
            [1, 0.999987245, 0.0018953667, 0.00467444398, -3.09017087e-05, 0.00219098455, -4.61087875e-05, -0.000147295141, 1.19e-07],
            [2, 0.999948084, 0.00368789397, 0.00949861296, -6.32390365e-05, 0.00356484344, -0.000590435171, -0.000311801123, 1.71e-07],
            [3, 0.999883533, 0.00561989052, 0.0141891278, -4.0590985e-05, 0.0056488011, -0.000178767557, -0.00032726361, 1.88e-07],
            [4, 0.999793649, 0.00747302268, 0.01889023, -4.26246697e-05, 0.00758709479, 8.59357988e-06, -0.000330156065, 1.14e-07],
            [5, 0.999679267, 0.00929496717, 0.0235723071, -6.89102162e-05, 0.00950131379, 2.23551342e-05, -0.000486146571, 1.25e-07],
            [6, 0.999539495, 0.011130604, 0.0282570366, -3.78381374e-05, 0.0111911623, 0.000488853606, -0.000583190529, 2.98e-07],
            [7, 0.999379575, 0.0127867889, 0.0328814238, -3.44010878e-05, 0.0130923456, 0.000176029323, -0.000778878748, 7.15e-07],
            [8, 0.99919498, 0.0143772643, 0.0375115722, -6.7219742e-05, 0.014728386, -0.000294563535, -0.00108387624, 7.15e-07],
            [9, 0.998986661, 0.0160146896, 0.0421216339, -5.26641343e-05, 0.016241923, -3.53275973e-05, -0.00114244339, 7.15e-07],
            [10, 0.998757541, 0.017587956, 0.0466925986, -6.79668592e-05, 0.0177780986, 0.000173874418, -0.00131367147, 7.15e-07],
            [11, 0.998514473, 0.0189963561, 0.0511530377, -8.70076619e-05, 0.0196201019, -0.000115046845, -0.00157396449, 8.34e-07],
            [12, 0.998249054, 0.0204265695, 0.0556467287, -8.89906514e-05, 0.0209249854, 0.000206108263, -0.0019777182, 8.94e-07],
            [13, 0.997973442, 0.0217170287, 0.0600628927, -8.87640708e-05, 0.0223829933, 0.000146623745, -0.0019917693, 1.19e-06],
            [14, 0.997674942, 0.0230030566, 0.0643874928, -8.23583396e-05, 0.0238812901, 0.000637140591, -0.00200135075, 1.19e-06],
            [15, 0.997365057, 0.0241033733, 0.0686456338, -0.000115607589, 0.0253803339, 0.000609327573, -0.00249277265, 1.19e-06],
            [16, 0.997045338, 0.0250150766, 0.0728379041, -0.000121781384, 0.02680628, 2.31773301e-05, -0.00278166006, 1.13e-06],
            [17, 0.996715784, 0.0259730183, 0.0769020692, -0.000128993677, 0.0285947658, 0.00030778072, -0.00300208945, 1.19e-06],
            [18, 0.996373236, 0.0268214364, 0.08094915, -0.000147536542, 0.029994376, 0.000611473806, -0.00323798554, 1.19e-06],
            [19, 0.996020913, 0.0275799055, 0.0849483311, -0.000153813307, 0.0311002769, 0.00111867348, -0.00343853096, 1.19e-06],
            [20, 0.995666921, 0.0281546842, 0.0888230428, -0.000169398685, 0.0324804708, 0.00107423472, -0.00377629092, 1.61e-06],
            [21, 0.995295823, 0.028640369, 0.0927425027, -0.000182782213, 0.0328182392, 0.00125261745, -0.00392480288, 1.37e-06],
            [22, 0.994955301, 0.0289511699, 0.0962396339, -0.000172969827, 0.0352874026, 0.00117056584, -0.00441011414, 1.57e-06],
            [23, 0.9945876, 0.0292756222, 0.0998883769, -0.000193561093, 0.0361873806, 0.00185798574, -0.00472718105, 2.52e-06],
            [24, 0.994231224, 0.029383067, 0.103377797, -0.000181237483, 0.0373130292, 0.00187015766, -0.00500662485, 3.46e-06],
            [25, 0.993879497, 0.0293744951, 0.106789105, -0.000201628296, 0.038321875, 0.00195492012, -0.00527702272, 7.69e-06],
            [26, 0.993526578, 0.0292397309, 0.110061258, -0.000189153943, 0.0394353829, 0.00203098194, -0.00572332507, 7.69e-06],
            [27, 0.993172109, 0.0289961472, 0.11327973, -0.000215550084, 0.0402330197, 0.00220145704, -0.00599501515, 7.69e-06],
            [28, 0.992837369, 0.0287082084, 0.116252057, -0.000203525153, 0.0418102928, 0.00282430649, -0.00641991151, 9.41e-06],
            [29, 0.992494285, 0.0282150749, 0.119272798, -0.000222418355, 0.0422815345, 0.00281033199, -0.00641204789, 7.39e-06],
            [30, 0.992173433, 0.0276809037, 0.122056723, -0.00021422666, 0.0434209183, 0.00342315645, -0.00683706533, 9.55e-06],
            [31, 0.991856694, 0.0270504169, 0.124793544, -0.000230815582, 0.0441742465, 0.00408974057, -0.00678682653, 1.44e-05],
            [32, 0.991545677, 0.0262413062, 0.127411351, -0.000230048434, 0.0447328426, 0.00431387546, -0.00720995292, 1.45e-05],
            [33, 0.991248548, 0.0253480487, 0.129881635, -0.000237681335, 0.0454675853, 0.00473938091, -0.00714542391, 1.46e-05],
            [34, 0.990969718, 0.0243325047, 0.13218534, -0.000238808789, 0.0462918952, 0.00507535646, -0.00754935294, 1.5e-05],
            [35, 0.990707934, 0.0232289694, 0.134333357, -0.000254557468, 0.0473588929, 0.00541892322, -0.0077475016, 1.58e-05],
            [36, 0.990444422, 0.0220296457, 0.136475816, -0.000230304388, 0.0473584905, 0.0058796159, -0.0079485774, 1.79e-05],
            [37, 0.990222514, 0.0207134038, 0.138310924, -0.000266377145, 0.0485462584, 0.00601950381, -0.00844960287, 2.26e-05],
            [38, 0.990009069, 0.0194190554, 0.140018031, -0.000277475978, 0.0495381728, 0.00695134513, -0.00889018364, 2.26e-05],
            [39, 0.989800632, 0.0179565866, 0.141679466, -0.000291439035, 0.0499595888, 0.0073818583, -0.00910305884, 2.29e-05],
            [40, 0.98960048, 0.01642612, 0.143262684, -0.000265379524, 0.0499270223, 0.0077816532, -0.0090279812, 2.29e-05],
            [41, 0.989439309, 0.014935609, 0.144550547, -0.000285691058, 0.05079953, 0.0089557115, -0.00935915578, 2.32e-05],
            [42, 0.989290953, 0.0132018616, 0.145771191, -0.000297803606, 0.0512376204, 0.00890910253, -0.00954484288, 2.38e-05],
            [43, 0.989172578, 0.0114905192, 0.146813914, -0.000292430195, 0.0518223532, 0.00937862135, -0.00969216414, 2.54e-05],
            [44, 0.989052594, 0.00974793639, 0.147745416, -0.000320740306, 0.0522136427, 0.00996138901, -0.00972695462, 2.54e-05],
            [45, 0.988954961, 0.00792936515, 0.148505405, -0.000321325002, 0.0525323525, 0.0103726229, -0.00994518306, 2.55e-05],
            [46, 0.988871098, 0.00606674422, 0.149152055, -0.000315157493, 0.0525960401, 0.0106993103, -0.0101322457, 2.57e-05],
            [47, 0.988806605, 0.00422130013, 0.149643451, -0.000316245103, 0.0526963994, 0.0112857297, -0.01027539, 2.6e-05],
            [48, 0.988764882, 0.00233569695, 0.149966002, -0.00030268071, 0.0529286154, 0.0117044114, -0.0102504138, 2.7e-05],
            [49, 0.988738179, 0.0004381623, 0.150172338, -0.000317335158, 0.0528660342, 0.0122470846, -0.0104544424, 2.94e-05],
            [50, 0.988734543, -0.00147232681, 0.150189191, -0.000334089942, 0.0530227274, 0.0127525833, -0.0107253445, 2.94e-05],
            [51, 0.988744676, -0.00344299991, 0.150090337, -0.000308545947, 0.0528501458, 0.0126684969, -0.0106862672, 2.93e-05],
            [52, 0.988775611, -0.00531882932, 0.149832502, -0.000314992882, 0.0527168661, 0.0132904276, -0.0107148979, 2.93e-05],
            [53, 0.988826036, -0.00717779202, 0.149422526, -0.000348602305, 0.052640941, 0.0138942404, -0.0107321516, 2.88e-05],
            [54, 0.98889792, -0.00901081134, 0.148849025, -0.000332352472, 0.052515652, 0.0145482309, -0.0107492311, 2.85e-05],
            [55, 0.988984764, -0.0108337784, 0.148155347, -0.000340280327, 0.0521855503, 0.0150293633, -0.0106456429, 2.67e-05],
            [56, 0.989093423, -0.0126650175, 0.147281051, -0.000374754571, 0.0520072468, 0.0151640382, -0.0109234136, 2.68e-05],
            [57, 0.989212513, -0.0143934209, 0.146319121, -0.000372251379, 0.051475998, 0.0156449284, -0.0106127262, 2.66e-05],
            [58, 0.989355624, -0.0160610825, 0.145171434, -0.000355747965, 0.0511048175, 0.0162439048, -0.0106013706, 2.68e-05],
            [59, 0.989518702, -0.0177291613, 0.143855602, -0.00033650297, 0.0508674048, 0.016442854, -0.0107137654, 2.69e-05],
            [60, 0.98969233, -0.0192823336, 0.142444417, -0.000320589344, 0.0502168052, 0.0169241987, -0.0105304187, 2.67e-05],
            [61, 0.989887953, -0.0207678452, 0.140841231, -0.000344891567, 0.0498247743, 0.0174214728, -0.0105183618, 2.66e-05],
            [62, 0.990101099, -0.0221156348, 0.139128298, -0.000327430345, 0.0492941588, 0.0182298291, -0.0102405138, 3.28e-05],
            [63, 0.990326047, -0.0234750342, 0.13729389, -0.000313790049, 0.0485155098, 0.0184664261, -0.0102585657, 3.91e-05],
            [64, 0.990574539, -0.0246502105, 0.135284394, -0.000322174776, 0.0480394252, 0.0194038078, -0.00979363918, 7.09e-05],
            [65, 0.990831077, -0.0258709192, 0.133170441, -0.000322928769, 0.047187604, 0.0193724949, -0.0100783994, 7.38e-05],
        ],
    },
    "mav": {
        "frames": 200,
        "failed": 0,
        "idepth_rmse": 0.03875426704064012,
        "precision": 1.0,
        "recall": 0.7514840494791667,
        "coverage": 0.6544596552848816,
        "ate_rmse": 0.011072163097593837,
        "ate_rmse_sim3": 0.00536709608855061,
        "gt_path_length": 3.3453696373496147,
        "rpe_trans_rmse": 0.0007593367279138683,
        "rpe_rot_rmse_deg": 0.015161580210662868,
        "rpe30_trans_rmse": 0.008456626741880968,
        "rpe30_rot_rmse_deg": 0.09465497633135596,
        "track_failed_frames": 0,
        "relocalizations": 0,
        "perturbed": [1, 2, 3],
        "parting_frame": 48,
        "ba_route": {'unsharded': {'solves': 0, 'points': []}, 'sharded': {'solves': 0, 'points': []}},
        "jax_devices": 1,
        "poses": [
            [0, 1, 0, 0, 0, 0, 0, 0, 0],
            [1, 0.999980807, 0.00135142112, 0.00390556199, 0.0045826463, 0.0150137674, 0.00692531094, 0.000651667011, 1.24e-07],
            [2, 0.999925137, 0.00245170039, 0.00773667684, 0.00915809907, 0.03002638, 0.0133507084, 0.00158997159, 7.43e-08],
            [3, 0.999834657, 0.00344156963, 0.0114620551, 0.0136888763, 0.045278579, 0.0202727281, 0.00303105824, 1.04e-07],
            [4, 0.999711514, 0.00420815172, 0.0151597029, 0.0181496777, 0.0601864867, 0.0268758647, 0.00476824818, 1.29e-07],
            [5, 0.999559283, 0.0046470766, 0.0187632069, 0.0225292221, 0.0751723722, 0.0324660018, 0.0068239728, 1.15e-07],
            [6, 0.999379456, 0.00493840408, 0.0223154221, 0.0268073287, 0.0899659693, 0.0382638574, 0.0090564806, 5.96e-08],
            [7, 0.999175966, 0.00493965158, 0.0257935822, 0.0309672263, 0.104570337, 0.0432599634, 0.0117188543, 1.23e-07],
            [8, 0.998953164, 0.00470783375, 0.0291452184, 0.034973152, 0.119345501, 0.0478841774, 0.0146598332, 1.6e-07],
            [9, 0.998711884, 0.00427261926, 0.0324350335, 0.0388247147, 0.134012058, 0.0521731041, 0.0178536642, 1.53e-07],
            [10, 0.998454273, 0.00367519818, 0.0356776044, 0.0425264202, 0.148164585, 0.0564530902, 0.0217546336, 2.68e-07],
            [11, 0.998186827, 0.00272335927, 0.0387916379, 0.0460728891, 0.162520736, 0.0595104247, 0.0255178027, 2.76e-07],
            [12, 0.997916818, 0.00156237523, 0.0418364406, 0.049354285, 0.176609442, 0.0621453151, 0.0297782421, 1.79e-07],
            [13, 0.99764961, 0.000260511413, 0.0447576605, 0.0524845086, 0.190689325, 0.0647431538, 0.0344062969, 2.87e-07],
            [14, 0.9973647, -0.00131903321, 0.0475758165, 0.0553303324, 0.204708502, 0.0663248971, 0.0392466597, 2.2e-07],
            [15, 0.997075021, -0.00301376032, 0.0503204763, 0.0579957552, 0.218414977, 0.0679966584, 0.0446262993, 4.32e-07],
            [16, 0.996792853, -0.00498262513, 0.0528919622, 0.0603880994, 0.232312292, 0.0687113404, 0.0502886586, 2.12e-07],
            [17, 0.996512413, -0.00715937046, 0.0554018393, 0.0625320822, 0.245846197, 0.0687951744, 0.056354139, 2.35e-07],
            [18, 0.99624145, -0.00947771128, 0.0577987246, 0.064412795, 0.259106666, 0.0685462877, 0.0626924038, 5.07e-07],
            [19, 0.995985329, -0.0120113418, 0.0600678436, 0.0660017952, 0.272315919, 0.067508623, 0.0692423731, 3.13e-07],
            [20, 0.995729148, -0.0146466112, 0.0622177683, 0.0673301965, 0.285346419, 0.0664184168, 0.0763450563, 3.13e-07],
            [21, 0.99548614, -0.0175565742, 0.064201057, 0.0683577135, 0.298558474, 0.0638852939, 0.0836478397, 3.28e-07],
            [22, 0.995251834, -0.0205024779, 0.0661257431, 0.0691100284, 0.311095804, 0.0615207106, 0.0916499346, 2.98e-07],
            [23, 0.995031834, -0.0235997308, 0.0679270625, 0.0695391148, 0.323388129, 0.0585487783, 0.0998574942, 3.28e-07],
            [24, 0.994826376, -0.026888011, 0.0695340931, 0.0696898997, 0.335847676, 0.0545286946, 0.108147599, 3.58e-07],
            [25, 0.994634807, -0.0301871691, 0.07104633, 0.0695389882, 0.347827077, 0.0506784767, 0.117158957, 6.56e-07],
            [26, 0.994454443, -0.033586897, 0.07246048, 0.0691005141, 0.359356165, 0.0464013778, 0.126711607, 6.56e-07],
            [27, 0.99429065, -0.037079107, 0.0737010837, 0.0683531016, 0.371024191, 0.0413227901, 0.136604637, 6.56e-07],
            [28, 0.994138241, -0.0406644903, 0.0748111606, 0.0673212036, 0.382201254, 0.0358416215, 0.146868706, 6.56e-07],
            [29, 0.993993998, -0.044268392, 0.0758322924, 0.0660246238, 0.392863482, 0.0300672371, 0.157540992, 6.56e-07],
            [30, 0.99386555, -0.0479277372, 0.0766867399, 0.0644047558, 0.40342024, 0.0237128437, 0.168715388, 6.56e-07],
            [31, 0.99374485, -0.0515731052, 0.07744582, 0.0625317842, 0.413367987, 0.0173031799, 0.180367529, 6.56e-07],
            [32, 0.993633091, -0.0552529953, 0.0780095905, 0.0604304075, 0.423288196, 0.0102835651, 0.192172199, 3.67e-06],
            [33, 0.993529916, -0.0589960478, 0.0784249976, 0.0580078736, 0.432696879, 0.00265794992, 0.204140902, 8.16e-06],
            [34, 0.993430257, -0.0627081543, 0.078757681, 0.0553147271, 0.441453189, -0.00529115275, 0.216653958, 4.54e-05],
            [35, 0.993337214, -0.066318661, 0.0789813176, 0.0524065159, 0.449557751, -0.0128700882, 0.230006441, 1.55e-05],
            [36, 0.993256152, -0.0698994771, 0.07895004, 0.0493133999, 0.457750052, -0.02109484, 0.242749408, 1.35e-05],
            [37, 0.993181944, -0.0732912943, 0.0789182037, 0.045991987, 0.464910656, -0.0284911059, 0.257103741, 2.06e-05],
            [38, 0.993097246, -0.0767093375, 0.0787083507, 0.0424690805, 0.471705943, -0.0366813205, 0.271316379, 3.1e-05],
            [39, 0.993016899, -0.0800327957, 0.0783483014, 0.038714692, 0.477919191, -0.0450429656, 0.285638392, 7.89e-05],
            [40, 0.992932916, -0.0832522511, 0.0778984576, 0.0347820967, 0.483469188, -0.0533721, 0.300673425, 5.65e-05],
            [41, 0.992853522, -0.0863752216, 0.0772064924, 0.0307279006, 0.488780677, -0.0619207062, 0.315119803, 8.46e-05],
            [42, 0.992775083, -0.0893418267, 0.0763934851, 0.0264882557, 0.493564576, -0.0702615678, 0.330280006, 8.54e-05],
            [43, 0.992684603, -0.092163384, 0.0755530223, 0.0221871585, 0.497298419, -0.0784424692, 0.346136391, 4.77e-05],
            [44, 0.992597461, -0.094872728, 0.0745082647, 0.0177713372, 0.500737429, -0.0869040117, 0.361734092, 7.53e-05],
            [45, 0.992524326, -0.0972181633, 0.0733997449, 0.013235826, 0.503016114, -0.0938884765, 0.377580225, 7.4e-05],
            [46, 0.992420018, -0.0997976586, 0.0720433071, 0.00858289097, 0.50540483, -0.103223801, 0.39317736, 7.77e-05],
            [47, 0.99231708, -0.102075875, 0.0707042515, 0.00388719514, 0.506432652, -0.111515477, 0.40958488, 8.77e-05],
        ],
    },
    "occlusion": {
        "frames": 190,
        "failed": 0,
        "idepth_rmse": 0.02957956966404852,
        "precision": 1.0,
        "recall": 0.8544349814967105,
        "coverage": 0.8645344972610474,
        "ate_rmse": 0.004098322511763632,
        "ate_rmse_sim3": 0.004096321349222194,
        "gt_path_length": 2.6433636216881906,
        "rpe_trans_rmse": 0.0006293814731011409,
        "rpe_rot_rmse_deg": 0.011917821097170963,
        "rpe30_trans_rmse": 0.005108024025871984,
        "rpe30_rot_rmse_deg": 0.09940445162353553,
        "track_failed_frames": 10,
        "relocalizations": 1,
        "perturbed": [1, 2, 3],
        "parting_frame": 108,
        "ba_route": {'unsharded': {'solves': 0, 'points': []}, 'sharded': {'solves': 0, 'points': []}},
        "jax_devices": 1,
        "poses": [
            [0, 1, 0, 0, 0, 0, 0, 0, 0],
            [1, 0.99999994, -8.27687472e-06, 0.000755275483, -7.85837801e-06, 0.019152442, 4.75551533e-05, 0.000600933447, 1.04e-07],
            [2, 0.999999464, -8.12580129e-06, 0.00156834931, -1.7059956e-05, 0.0378730111, 0.000304372632, 0.00138348714, 4.03e-08],
            [3, 0.999998987, -6.86746216e-06, 0.00230144686, -1.61922908e-05, 0.0571339875, 0.000736193557, 0.00183815463, 7.82e-08],
            [4, 0.999998987, -4.00727804e-05, 0.00313823391, -5.10179962e-05, 0.0756388158, 0.00109161437, 0.00255503971, 5.96e-08],
            [5, 1.00000143, -2.04989447e-05, 0.00390937831, -4.45743281e-05, 0.0944528729, 0.00201592711, 0.0033393479, 7.29e-08],
            [6, 1.00001109, -1.7966644e-05, 0.00467414828, -3.31264782e-05, 0.113268547, 0.00305753225, 0.00380603038, 1.64e-07],
            [7, 1.00003791, -1.76307731e-05, 0.00545943761, -3.28533388e-05, 0.131668001, 0.00419698888, 0.00428148033, 2.98e-08],
            [8, 1.0000335, -1.49820744e-05, 0.0061965026, -1.85847584e-05, 0.150231868, 0.00568229798, 0.00449499208, 2.84e-07],
            [9, 1.00002885, -3.36751577e-06, 0.00691233249, -2.0238469e-05, 0.168784916, 0.00713743456, 0.00520266313, 1.98e-07],
            [10, 1.00002372, 6.5501692e-05, 0.00762453722, -2.41089947e-06, 0.187124819, 0.00936253741, 0.00581489597, 1.22e-07],
            [11, 1.00001836, 7.53114e-05, 0.00828711223, 3.69779445e-06, 0.205542237, 0.0113258325, 0.0064281188, 2.23e-07],
            [12, 1.00001121, 3.55017582e-05, 0.0090747457, -1.02448448e-05, 0.222940043, 0.0130478386, 0.00668707397, 3.17e-07],
            [13, 1.0000031, -7.74539876e-06, 0.00990559347, -2.4537072e-05, 0.239880815, 0.0149277747, 0.00661520846, 2.76e-07],
            [14, 0.99999392, -3.37218953e-05, 0.0107932538, -5.90250202e-05, 0.256243765, 0.0171135142, 0.00658704108, 1.51e-07],
            [15, 0.999985933, -8.48775962e-05, 0.0115087926, -4.18134769e-05, 0.273171842, 0.0192892347, 0.00673738495, 3.46e-07],
            [16, 0.999978185, -7.59197937e-05, 0.0121926721, -8.75800833e-05, 0.290097058, 0.0219596885, 0.00711824372, 2.75e-07],
            [17, 0.999969661, -0.000136183138, 0.012896955, -0.000111631518, 0.30632472, 0.0244266316, 0.00707619078, 3.28e-07],
            [18, 0.999961078, -0.000155400223, 0.0136041036, -8.94899131e-05, 0.32224077, 0.0272704307, 0.00743435696, 2.33e-07],
            [19, 0.99995482, -8.42023073e-05, 0.0142200384, -0.000123400299, 0.338282347, 0.0307930652, 0.00782761071, 2.24e-07],
            [20, 0.999947011, -9.79757751e-05, 0.0147496052, -0.000119575576, 0.354384989, 0.033878874, 0.00816829503, 4.27e-07],
            [21, 0.99993521, -0.000179699258, 0.015512282, -0.000179411814, 0.368622601, 0.0368352756, 0.00846952852, 4.15e-07],
            [22, 0.999924839, -0.000145209036, 0.0161323026, -0.000147400307, 0.383356482, 0.0407023653, 0.00851373281, 3.56e-07],
            [23, 0.999914467, -4.68759972e-05, 0.0166772138, -0.000161960998, 0.39823243, 0.0449720733, 0.0087598972, 3.59e-07],
            [24, 0.999901116, -0.00015757051, 0.0172636863, -0.000168687271, 0.412172318, 0.0480696633, 0.00897955056, 3.41e-07],
            [25, 0.999882519, -0.000132583431, 0.0178640299, -0.000154327689, 0.425510824, 0.052190505, 0.00914909504, 5.31e-07],
            [26, 0.999871075, -0.00010125251, 0.018492328, -0.000149845466, 0.43814978, 0.0563875325, 0.00939934235, 7.11e-07],
            [27, 0.999861956, -0.000197810441, 0.0189852491, -0.000191375104, 0.451119602, 0.059998855, 0.00937347952, 5.24e-07],
            [28, 0.999851167, -0.000183218173, 0.0195555873, -0.000207782956, 0.462939471, 0.0643910915, 0.00985810906, 5.12e-07],
            [29, 0.999842644, -0.000224062562, 0.0200021621, -0.000206410681, 0.47514984, 0.0685566589, 0.00977495592, 6.68e-07],
            [30, 0.999834061, -0.000222671748, 0.0204722155, -0.000203443822, 0.486479163, 0.0731175765, 0.0100599863, 5.91e-07],
            [31, 0.999826968, -0.000197064452, 0.020917654, -0.000191328436, 0.497366726, 0.0780020282, 0.0101206396, 6.12e-07],
            [32, 0.999817789, -0.000147851635, 0.0213539563, -0.000155836635, 0.507714212, 0.0830498934, 0.0105044665, 6.1e-07],
            [33, 0.999808252, -0.000202572512, 0.0217884686, -0.000173103006, 0.517343462, 0.0875065029, 0.0106325056, 6.69e-07],
            [34, 0.99980098, -0.000209975304, 0.0221064147, -0.000191244719, 0.527142704, 0.0923559889, 0.0107830605, 8.52e-07],
            [35, 0.999791205, -0.000295523496, 0.0225130059, -0.000208151265, 0.535658717, 0.0968529508, 0.0108812563, 7.08e-07],
            [36, 0.999782264, -0.00035536103, 0.0228276141, -0.000219947484, 0.54417026, 0.101528928, 0.011246697, 7.93e-07],
            [37, 0.999770224, -0.000281010638, 0.0231860373, -0.00020725916, 0.551705301, 0.107247047, 0.0116963657, 7.12e-07],
            [38, 0.999764264, -0.00030051131, 0.0234474465, -0.00021047768, 0.559169531, 0.112343952, 0.011798935, 8.05e-07],
            [39, 0.999758005, -0.000275858358, 0.0237117056, -0.000200884286, 0.565825284, 0.117763646, 0.012549689, 7.39e-07],
            [40, 0.999751389, -0.000327524205, 0.0239954758, -0.000249023928, 0.571627736, 0.122811735, 0.012701205, 7.53e-07],
            [41, 0.999747634, -0.000311497657, 0.0241700355, -0.000217087087, 0.577478886, 0.128391832, 0.0133655546, 8.52e-07],
            [42, 0.999742031, -0.000301623892, 0.0244374909, -0.0002226941, 0.582030356, 0.133953989, 0.0135223251, 7.9e-07],
            [43, 0.999739528, -0.000329883216, 0.0246386472, -0.000240798734, 0.586273372, 0.139258951, 0.0138008967, 8.25e-07],
            [44, 0.999736488, -0.000386677915, 0.024756005, -0.000282459019, 0.590241015, 0.144515336, 0.014075892, 8.79e-07],
            [45, 0.999731243, -0.000398981851, 0.0249709934, -0.000312034914, 0.592916787, 0.150000483, 0.0147377225, 8.37e-07],
            [46, 0.999729395, -0.000319015613, 0.0250339992, -0.000283674221, 0.595628142, 0.156211019, 0.0156325959, 8.85e-07],
            [47, 0.999726534, -0.000377921155, 0.0251347255, -0.000317035709, 0.597620606, 0.161467493, 0.0152536687, 7.58e-07],
            [48, 0.999724925, -0.00030338479, 0.0251580831, -0.000266453746, 0.599154711, 0.167534038, 0.016722681, 8.87e-07],
            [49, 0.99972254, -0.000305036752, 0.0251587741, -0.000261836918, 0.60002476, 0.173283428, 0.0175580643, 7.9e-07],
            [50, 0.999722004, -0.000309409632, 0.0251802262, -0.0002834404, 0.600178421, 0.179137141, 0.0184519365, 8.88e-07],
            [51, 0.999721467, -0.00037157652, 0.0252063833, -0.000277894258, 0.599380374, 0.184400082, 0.0192316677, 7.92e-07],
            [52, 0.999724388, -0.000268787117, 0.025093684, -0.000291224802, 0.598635793, 0.190773085, 0.0200240463, 7.15e-07],
            [53, 0.99972713, -0.000224256757, 0.0250004698, -0.000303813606, 0.597305536, 0.196672484, 0.0206807479, 9.39e-07],
            [54, 0.999728858, -0.000283114146, 0.0249636658, -0.000272158184, 0.594737172, 0.201986089, 0.0215327814, 7.15e-07],
            [55, 0.999735177, -0.000282251305, 0.024804553, -0.000241779897, 0.591994226, 0.207626402, 0.0228348654, 1.1e-06],
            [56, 0.999740005, -0.000288369047, 0.0246104393, -0.000216190485, 0.588796735, 0.213368639, 0.0239180103, 1.23e-06],
            [57, 0.999741495, -0.000323462591, 0.0245500002, -0.000222125949, 0.584104896, 0.218635038, 0.0245892685, 1.59e-06],
            [58, 0.999746919, -0.000306333764, 0.0243281014, -0.000223287978, 0.579751432, 0.224236593, 0.025489362, 2.21e-06],
            [59, 0.999753058, -0.000248682249, 0.0240935478, -0.000233797706, 0.57477212, 0.230135441, 0.02660124, 2.67e-06],
            [60, 0.999759793, -0.000326696376, 0.0238304939, -0.000223608396, 0.56907618, 0.235116959, 0.027420748, 2.44e-06],
            [61, 0.999766886, -0.000343660184, 0.0236023683, -0.000222445844, 0.562508404, 0.240351856, 0.0285560545, 3.28e-06],
            [62, 0.999774754, -0.000319841725, 0.0232644528, -0.00019343711, 0.555794418, 0.245903179, 0.0297389943, 3.8e-06],
            [63, 0.999781549, -0.000377232936, 0.0229772106, -0.000188068938, 0.548051, 0.250782639, 0.0307535008, 4.47e-06],
            [64, 0.999790251, -0.000372593116, 0.0226028282, -0.000181533833, 0.540350795, 0.255861789, 0.0318553783, 4.89e-06],
            [65, 0.999799609, -0.000338947022, 0.0222065505, -0.00019311544, 0.532199144, 0.261190265, 0.0329465233, 6.2e-06],
            [66, 0.999808252, -0.000378400291, 0.0218541604, -0.000212664207, 0.522789776, 0.266137093, 0.0343882963, 7.69e-06],
            [67, 0.999819219, -0.000344827888, 0.0214667916, -0.000192439489, 0.513055146, 0.271264642, 0.0356066152, 9.72e-06],
            [68, 0.999830365, -0.000321600062, 0.0209488459, -0.000177091148, 0.503443539, 0.276332825, 0.0366346389, 1.16e-05],
            [69, 0.999839544, -0.000287927949, 0.0205146875, -0.000129201813, 0.492786139, 0.281322449, 0.038083896, 2.03e-05],
            [70, 0.999848247, -0.000268447446, 0.020103408, -0.000153370958, 0.481176108, 0.286091447, 0.0392913297, 1.06e-05],
            [71, 0.999859154, -0.000271619909, 0.0196075272, -0.000173301902, 0.469730824, 0.290622532, 0.0404706672, 1.27e-05],
            [72, 0.999871194, -0.000326854934, 0.019105874, -0.000195893779, 0.457646459, 0.294727236, 0.0417306274, 1.12e-05],
            [73, 0.999888599, -0.00034590991, 0.0185018107, -0.000164986501, 0.445589334, 0.2989856, 0.0430280752, 1.64e-05],
            [74, 0.999900877, -0.000337945356, 0.0178302247, -0.000125103747, 0.433295369, 0.303321004, 0.0446537547, 1.27e-05],
            [75, 0.999909937, -0.000407759071, 0.0173236337, -0.000135893191, 0.419490159, 0.30702737, 0.0457957722, 1.53e-05],
            [76, 0.999920249, -0.000299403298, 0.0167399626, -0.000162989672, 0.405627221, 0.311522484, 0.047189597, 2.02e-05],
            [77, 0.999931514, -0.000348423782, 0.0161023159, -0.00010754395, 0.391615152, 0.315046847, 0.048332639, 4.6e-05],
            [78, 0.99994272, -0.000369140878, 0.0155070005, -0.000129827647, 0.376829743, 0.318715364, 0.0496440232, 2.16e-05],
            [79, 0.999957144, -0.000289745047, 0.0148864407, -0.000126175786, 0.361678213, 0.322667986, 0.0508891381, 1.4e-05],
            [90, 1.00026166, -0.000243433111, 0.00690505141, -5.64098882e-05, 0.176605359, 0.3516469, 0.0638286993, 3.85e-05],
            [91, 1.00026667, -0.00026680046, 0.00612093927, -5.25386349e-05, 0.15807794, 0.353265077, 0.0649087727, 3.85e-05],
            [92, 1.00027251, -0.000216474946, 0.00506310491, -3.19878163e-05, 0.140846953, 0.355161518, 0.0662611276, 3.85e-05],
            [93, 1.00027502, -0.0003035095, 0.00455017714, -4.67609862e-05, 0.120839253, 0.355766833, 0.0665543675, 3.86e-05],
            [94, 1.00027835, -0.000276738603, 0.00370061607, -5.44047725e-05, 0.102341503, 0.356885672, 0.067658186, 3.87e-05],
            [95, 1.00028145, -0.000187972881, 0.00272875908, -1.55132475e-05, 0.084515363, 0.358333647, 0.0690519363, 6.27e-05],
            [96, 1.000283, -0.000248884899, 0.00207704166, -3.06037909e-05, 0.0646875277, 0.358680993, 0.069500789, 4.99e-05],
            [97, 1.00028372, -0.000206357756, 0.00115194416, -4.59491384e-05, 0.0463789701, 0.359522164, 0.0706146583, 4.12e-05],
            [98, 1.00028455, -0.000171670152, 6.03911831e-05, -2.9153487e-05, 0.0287016537, 0.360122174, 0.0717016384, 4.09e-05],
            [99, 1.00028431, -0.000161734861, -0.00073383149, -3.62907485e-05, 0.00941501558, 0.36034584, 0.0725234747, 4.09e-05],
            [100, 1.00028384, -0.000143374113, -0.00159917714, -5.57022831e-05, -0.00931150839, 0.360427469, 0.0732370317, 4.01e-05],
            [101, 1.00028324, -0.000177254275, -0.00230071717, -4.66251367e-05, -0.029078193, 0.36006856, 0.0736765563, 3.84e-05],
            [102, 1.000283, -0.000156238864, -0.003204701, -3.74216906e-05, -0.0476292819, 0.359859109, 0.0743615776, 3.45e-05],
            [103, 1.00028551, -0.000150174892, -0.00399119686, -6.57435739e-05, -0.0667823851, 0.359388173, 0.074932687, 5e-05],
            [104, 1.00028133, -0.000156796188, -0.00492963055, -6.35127944e-05, -0.0851388201, 0.358514637, 0.0755513161, 7.91e-05],
            [105, 1.00027692, -7.60202674e-05, -0.00575840147, -5.9126698e-05, -0.103903808, 0.358156294, 0.0763428882, 7.91e-05],
            [106, 1.00027239, -4.93520747e-05, -0.00654315576, -9.48301167e-05, -0.12268246, 0.3572914, 0.0769612417, 6.1e-05],
            [107, 1.00026762, -0.000156327907, -0.00729304133, -0.000105505052, -0.141593575, 0.355379403, 0.0770916492, 9.06e-05],
        ],
    },
    "pod_dense": {
        "frames": 200,
        "failed": 0,
        "idepth_rmse": 0.049510225802659985,
        "precision": 1.0,
        "recall": 0.7600398763020835,
        "coverage": 0.7876042127609253,
        "ate_rmse": 0.006572901838236689,
        "ate_rmse_sim3": 0.006555137305161094,
        "gt_path_length": 2.643495964324188,
        "rpe_trans_rmse": 0.0011842171227295414,
        "rpe_rot_rmse_deg": 0.02344921350590993,
        "rpe30_trans_rmse": 0.008345768295873494,
        "rpe30_rot_rmse_deg": 0.2652213010983467,
        "track_failed_frames": 0,
        "relocalizations": 0,
        "ba_solves": 32,
        "perturbed": [1, 2, 3, 4, 5, 6, 7],
        "parting_frame": 35,
        "ba_route": {'unsharded': {'solves': 32, 'points': [16384]}, 'sharded': {'solves': 0, 'points': []}},
        "jax_devices": 1,
        "ba_costs": [1.6760051250457764, 1.7501733303070068, 1.8400570154190063],
        "poses": [
            [0, 1, 0, 0, 0, 0, 0, 0, 0],
            [1, 0.99999994, -8.27687472e-06, 0.000755275483, -7.85837801e-06, 0.019152442, 4.75551533e-05, 0.000600933447, 1.04e-07],
            [2, 0.999999464, -8.12580129e-06, 0.00156834931, -1.7059956e-05, 0.0378730111, 0.000304372632, 0.00138348714, 6.41e-08],
            [3, 0.999998987, -6.86746216e-06, 0.00230144686, -1.61922908e-05, 0.0571339875, 0.000736193557, 0.00183815463, 7.9e-08],
            [4, 0.999998987, -4.00727804e-05, 0.00313823391, -5.10179962e-05, 0.0756388158, 0.00109161437, 0.00255503971, 5.96e-08],
            [5, 1.00000143, -2.04989447e-05, 0.00390937831, -4.45743281e-05, 0.0944528729, 0.00201592711, 0.0033393479, 9.59e-08],
            [6, 1.00001109, -1.7966644e-05, 0.00467414828, -3.31264782e-05, 0.113268547, 0.00305753225, 0.00380603038, 1.64e-07],
            [7, 1.00003791, -1.76307731e-05, 0.00545943761, -3.28533388e-05, 0.131668001, 0.00419698888, 0.00428148033, 9.59e-08],
            [8, 1.00003433, -2.29984871e-05, 0.00609425874, 3.06322181e-06, 0.150924355, 0.00566896936, 0.00473306561, 1.64e-07],
            [9, 1.00002933, -3.25651672e-05, 0.00687524211, 1.33488502e-05, 0.169052705, 0.00695743132, 0.00558837224, 1.39e-06],
            [10, 1.00002396, -1.06636826e-05, 0.00763842929, 1.57604773e-05, 0.187034205, 0.00887603499, 0.005891582, 1.15e-06],
            [11, 1.00001919, -3.86080901e-05, 0.00834825542, 9.08261427e-06, 0.205212206, 0.0105350604, 0.00634628907, 3.33e-06],
            [12, 1.00001431, -4.45167279e-05, 0.00909336191, -4.48290666e-06, 0.222812325, 0.0124852601, 0.00677372888, 2.67e-06],
            [13, 1.00001121, -6.85997147e-05, 0.00983982347, 9.3846611e-06, 0.240332395, 0.0145321731, 0.00702416804, 2.78e-06],
            [14, 1.00000346, -8.76227787e-05, 0.0105694458, -1.33144476e-05, 0.257509947, 0.016768435, 0.00752048846, 3.43e-06],
            [15, 0.999995351, -6.88358559e-05, 0.0112812258, 8.68650841e-06, 0.274495423, 0.0193840824, 0.00776700489, 8.73e-06],
            [16, 0.999987066, -0.000114105977, 0.0119195953, -2.11666829e-05, 0.291631162, 0.0217242427, 0.00830065459, 5.42e-06],
            [17, 0.999976099, -0.00015537352, 0.0126472348, -2.08121128e-05, 0.307851613, 0.0243788809, 0.00817339588, 2.82e-05],
            [18, 0.999962807, -7.22438344e-05, 0.013301814, -5.83753535e-06, 0.324041009, 0.0279089063, 0.00885377917, 2.31e-05],
            [19, 0.999942422, -0.000100343634, 0.0139474235, -1.68992956e-05, 0.339920819, 0.030763885, 0.00918225013, 1.04e-05],
            [20, 0.99993521, -6.27931222e-05, 0.0144481305, -7.47550621e-06, 0.356125146, 0.0342109688, 0.00979005359, 1.7e-05],
            [21, 0.999924302, -7.49909086e-05, 0.0151762674, -5.19245878e-05, 0.370596588, 0.0376501307, 0.0102438033, 2.71e-05],
            [22, 0.999915719, 1.94489203e-05, 0.0157124531, 1.12410453e-05, 0.385792315, 0.0418976992, 0.0107438108, 1.01e-05],
            [23, 0.999905527, 3.28311908e-05, 0.0163195543, -5.41364625e-06, 0.400155991, 0.0456165299, 0.0110597396, 1.83e-05],
            [24, 0.999895096, -4.85771452e-05, 0.0168807749, -4.54831024e-07, 0.414284408, 0.0489860587, 0.0111473026, 4.67e-05],
            [25, 0.999882102, -1.35529153e-05, 0.0174661968, -1.93380165e-05, 0.42783463, 0.0530802608, 0.011317635, 1.62e-05],
            [26, 0.999872029, 1.6445445e-05, 0.0180335976, -1.20599725e-06, 0.440790951, 0.0572900809, 0.0118266838, 1.63e-05],
            [27, 0.999862731, -6.84831757e-05, 0.0185431335, -5.99051637e-05, 0.453738451, 0.0609148145, 0.0118053081, 1.64e-05],
            [28, 0.999852657, 1.39886361e-05, 0.0190861207, -7.02683174e-05, 0.465687633, 0.0657366067, 0.0125056095, 1.65e-05],
            [29, 0.999844134, 5.79072594e-06, 0.0195504185, -6.37704943e-05, 0.477763474, 0.0701780096, 0.0124453763, 3.69e-05],
            [30, 0.999836326, 9.66286734e-06, 0.0199958906, -5.25603136e-05, 0.489191145, 0.0748299733, 0.0129872765, 4.94e-05],
            [31, 0.999830484, 4.35336369e-05, 0.0203928445, 1.15217626e-05, 0.500307858, 0.0798650682, 0.0132699497, 7.02e-05],
            [32, 0.999822199, 0.00011332093, 0.0207985956, 5.92589931e-05, 0.510814607, 0.0850832835, 0.013854051, 7.42e-05],
            [33, 0.999813139, 4.39920332e-05, 0.0212415904, 3.75707205e-05, 0.520388365, 0.0894212276, 0.0140411668, 8.86e-05],
            [34, 0.999806046, 4.04715756e-05, 0.0215879716, 2.03914715e-05, 0.530097961, 0.094332017, 0.0141546354, 9.69e-05],
        ],
    },
}
JAX_TRACK_ACCEPT_SPREAD = {
    "easy": {
        "frames": (200, 200),
        "failed": (0, 0),
        "idepth_rmse": (0.02860487670637667, 0.028738735783845185),
        "precision": (1.0, 1.0),
        "recall": (0.8542815429687499, 0.8544557942708332),
        "coverage": (0.8516764640808105, 0.8548502922058105),
        "ate_rmse": (0.004394539662384737, 0.005000753362575387),
        "ate_rmse_sim3": (0.0041383467810793585, 0.0047271764760814655),
        "gt_path_length": (2.643495964324188, 2.643495964324188),
        "rpe_trans_rmse": (0.0005944293112865234, 0.0006069214514733884),
        "rpe_rot_rmse_deg": (0.010791517113334126, 0.010937679725570306),
        "rpe30_trans_rmse": (0.005570244650839392, 0.006303761504692821),
        "rpe30_rot_rmse_deg": (0.07936589630828049, 0.08637832086915276),
        "track_failed_frames": (0, 0),
        "relocalizations": (0, 0),
    },
    "easy_ba": {
        "frames": (200, 200),
        "failed": (0, 0),
        "idepth_rmse": (0.02973144467920065, 0.03253225232474506),
        "precision": (1.0, 1.0),
        "recall": (0.855053369140625, 0.86435458984375),
        "coverage": (0.8465267419815063, 0.8900228142738342),
        "ate_rmse": (0.005723843751799837, 0.016293811628298963),
        "ate_rmse_sim3": (0.0026053723457874494, 0.006447014843386079),
        "gt_path_length": (2.643495964324188, 2.643495964324188),
        "rpe_trans_rmse": (0.0006111892775733234, 0.0008180280092683388),
        "rpe_rot_rmse_deg": (0.01073105298500462, 0.012874451414749393),
        "rpe30_trans_rmse": (0.005789808043247339, 0.012919497277190632),
        "rpe30_rot_rmse_deg": (0.059642653099890315, 0.13409005398969387),
        "track_failed_frames": (0, 0),
        "relocalizations": (0, 0),
        "ba_solves": (23, 28),
        "ba_costs": [(2.822347640991211, 2.8223793506622314), (2.3683390617370605, 2.3944759368896484), (2.761955499649048, 2.7621121406555176)],
    },
    "low_texture": {
        "frames": (200, 200),
        "failed": (0, 0),
        "idepth_rmse": (0.03219153127633035, 0.03376659939065576),
        "precision": (1.0, 1.0),
        "recall": (0.8677171061197916, 0.8685719401041666),
        "coverage": (0.84033203125, 0.8512630462646484),
        "ate_rmse": (0.0060899345710282195, 0.008121446767363942),
        "ate_rmse_sim3": (0.0059150413362488215, 0.0079572613825604),
        "gt_path_length": (2.643495964324188, 2.643495964324188),
        "rpe_trans_rmse": (0.002456304912008516, 0.005973607662840284),
        "rpe_rot_rmse_deg": (0.04837327453107416, 0.11854695056814707),
        "rpe30_trans_rmse": (0.007214005008102332, 0.010290482285059516),
        "rpe30_rot_rmse_deg": (0.12799411741045252, 0.19502250707880914),
        "track_failed_frames": (0, 0),
        "relocalizations": (0, 0),
    },
    "rotation": {
        "frames": (200, 200),
        "failed": (0, 0),
        "idepth_rmse": (0.03669697434641421, 0.040977276712656024),
        "precision": (1.0, 1.0),
        "recall": (0.7787625162760418, 0.7819584798177084),
        "coverage": (0.7368489503860474, 0.7518978118896484),
        "ate_rmse": (0.009391362497051524, 0.010061900803846367),
        "ate_rmse_sim3": (0.0024399393622364764, 0.0035317182242105877),
        "gt_path_length": (0.267369855260486, 0.267369855260486),
        "rpe_trans_rmse": (0.0005177460209545535, 0.0005429901895150086),
        "rpe_rot_rmse_deg": (0.009384612576669475, 0.00987298013393876),
        "rpe30_trans_rmse": (0.00857156204049293, 0.009798179603004883),
        "rpe30_rot_rmse_deg": (0.1630344765742632, 0.1838725241153101),
        "track_failed_frames": (0, 0),
        "relocalizations": (0, 0),
    },
    "rotation_ba": {
        "frames": (200, 200),
        "failed": (0, 0),
        "idepth_rmse": (0.03721799096092582, 0.0434986669011414),
        "precision": (1.0, 1.0),
        "recall": (0.7848537272135416, 0.7917287923177083),
        "coverage": (0.7197005152702332, 0.7492057681083679),
        "ate_rmse": (0.007307216430272451, 0.010993846994989407),
        "ate_rmse_sim3": (0.0023052764890729013, 0.0038533311195003386),
        "gt_path_length": (0.267369855260486, 0.267369855260486),
        "rpe_trans_rmse": (0.0005195393028547635, 0.0005507648194861349),
        "rpe_rot_rmse_deg": (0.009440716594267443, 0.010086369637522359),
        "rpe30_trans_rmse": (0.007160306130502695, 0.009967314208352101),
        "rpe30_rot_rmse_deg": (0.14587804905457946, 0.19676545203993606),
        "track_failed_frames": (0, 0),
        "relocalizations": (0, 0),
        "ba_solves": (25, 28),
        "ba_costs": [(1.627350091934204, 1.6274971961975098), (1.6090975999832153, 1.6093525886535645), (2.2048659324645996, 2.2312045097351074)],
    },
    "mav": {
        "frames": (200, 200),
        "failed": (0, 0),
        "idepth_rmse": (0.03872619372792542, 0.038993773628026245),
        "precision": (1.0, 1.0),
        "recall": (0.7511710286458333, 0.7514840494791667),
        "coverage": (0.6445377469062805, 0.6555240750312805),
        "ate_rmse": (0.011072163097593837, 0.0115237274750341),
        "ate_rmse_sim3": (0.00536709608855061, 0.005650875164061267),
        "gt_path_length": (3.3453696373496147, 3.3453696373496147),
        "rpe_trans_rmse": (0.0006568617707994316, 0.0007593367279138683),
        "rpe_rot_rmse_deg": (0.012140745400085974, 0.015161580210662868),
        "rpe30_trans_rmse": (0.008453566378497201, 0.008626323657725015),
        "rpe30_rot_rmse_deg": (0.0893634462865107, 0.09465497633135596),
        "track_failed_frames": (0, 0),
        "relocalizations": (0, 0),
    },
    "occlusion": {
        "frames": (190, 190),
        "failed": (0, 0),
        "idepth_rmse": (0.02946571512637954, 0.029579889166511986),
        "precision": (1.0, 1.0),
        "recall": (0.8540553556743421, 0.8544596182839912),
        "coverage": (0.8603515625, 0.8645344972610474),
        "ate_rmse": (0.004098322511763632, 0.0046924544300803415),
        "ate_rmse_sim3": (0.004096321349222194, 0.004689540792460238),
        "gt_path_length": (2.6433636216881906, 2.6433636216881906),
        "rpe_trans_rmse": (0.0006274006045083546, 0.0006466009224945104),
        "rpe_rot_rmse_deg": (0.011876318268054605, 0.012097265913298395),
        "rpe30_trans_rmse": (0.005108024025871984, 0.0058370214762756886),
        "rpe30_rot_rmse_deg": (0.09940445162353553, 0.1046940365382085),
        "track_failed_frames": (10, 10),
        "relocalizations": (1, 1),
    },
    "pod_dense": {
        "frames": (200, 200),
        "failed": (0, 0),
        "idepth_rmse": (0.040418007099069654, 0.055129185295663775),
        "precision": (1.0, 1.0),
        "recall": (0.7592030924479167, 0.7600398763020835),
        "coverage": (0.7852051258087158, 0.790856122970581),
        "ate_rmse": (0.0034984819000319334, 0.008586755700654456),
        "ate_rmse_sim3": (0.003483962648049998, 0.008459873662377488),
        "gt_path_length": (2.643495964324188, 2.643495964324188),
        "rpe_trans_rmse": (0.0008393950422144811, 0.00123810912458506),
        "rpe_rot_rmse_deg": (0.01812331798918006, 0.024682641646164988),
        "rpe30_trans_rmse": (0.005412419653681231, 0.011625402458378538),
        "rpe30_rot_rmse_deg": (0.20753482221036645, 0.3205960743674542),
        "track_failed_frames": (0, 0),
        "relocalizations": (0, 0),
        "ba_solves": (32, 32),
        "ba_costs": [(1.675466775894165, 1.6760272979736328), (1.7501486539840698, 1.7504709959030151), (1.8398982286453247, 1.8412401676177979)],
    },
}

# Phase 16: the streaming acceptance protocol of
# scripts/chip_acc_streaming.py through the port
# (scripts/chip_acc_streaming_torch.py) on phase 14's default frames. The
# JAX package's run of the same frames (the port's CPU rendering) with the
# pinned install schedule, unrounded, and its seconds on an 8-core CPU
# (beside a second run; --schedule free gave the same numbers there):
#   JAX_PLATFORMS=cpu python scripts/jax_streaming_reference.py \
#       --schedule pinned
JAX_STREAM_ACCEPT = {
    "frames": 200, "idepth_rmse": 0.02696071231737733, "precision": 1.0,
    "recall": 0.7884406901041667, "steady_recall": 0.8291207465277777,
    "steady_coverage": 0.8291207659244537,
    "final_coverage": 0.8287304639816284, "frames_evaluated": 200,
    "frames_failed": 0, "tri_dropped": 0, "topo_installs": 33,
    "stale_tri_windows": 0, "tri_superseded": 0, "poseframes": 34,
    "seconds": 205.4}
# Phase 16 (d) holds the card's pinned run to it: rmse relative, the rest
# absolute (JAX_BAND; precision 0.02), and these counts equal.
STREAM_BAND = {"idepth_rmse": JAX_BAND["idepth_rmse"],
               "recall": JAX_BAND["recall"],
               "steady_recall": JAX_BAND["recall"],
               "steady_coverage": JAX_BAND["coverage"],
               "final_coverage": JAX_BAND["coverage"], "precision": 0.02}
STREAM_EQUAL = ("topo_installs", "frames_evaluated")
# JAX_BAND is the ceiling. A run that took the pinned schedule is also
# held to STREAM_TIGHT, relative, on every key of STREAM_BAND: the card's
# pinned run and the port's on the CPU sit at most 3.3e-6 from
# JAX_STREAM_ACCEPT, while the band's control, which phase 16 runs and
# which must leave it, moved rmse 4.1e-4 and steady recall 1.1e-3 inside
# JAX_BAND: the pinned run with the depth filter's posterior means
# rounded to bfloat16 after each window, as a port that kept them in
# bfloat16 would (PERF.md, PR 14).
STREAM_TIGHT = 1e-4
# The window whose id buffer phase 16 checks: frames 150-155, its
# poseframe past the third wrap of the keyframe ring (frame 144).
STREAM_CHECK_WINDOW = 25

def track_sequence(name):
    """A tracking acceptance run's `make_sequence` keyword arguments, in
    full (those of accept_sequence)."""
    return dict(dict(motion="strafe", scene="room", texture_gain=1.0,
                     exposure_amp=0.0), **TRACK_ACCEPT_RUNS[name]["seq"])


def track_argv(name):
    """The offline runner's arguments of a tracking acceptance run."""
    argv = ["--dataset", "synthetic", "--resolution", "vga", "--frames",
            str(ACCEPT_FRAMES), "--pose-source", "tracking"]
    for key, value in TRACK_ACCEPT_RUNS[name]["seq"].items():
        argv += ["--" + key.replace("_", "-"), str(value)]
    extra = list(TRACK_ACCEPT_RUNS[name]["args"])
    if "--config" in extra:
        i = extra.index("--config") + 1
        extra[i] = os.path.join(REPO, extra[i])
    return argv + extra


def track_option(name, flag):
    """The value of a tracking acceptance run's extra argument `flag`
    (None if absent; True for a flag without a value)."""
    args = list(TRACK_ACCEPT_RUNS[name]["args"])
    if flag not in args:
        return None
    i = args.index(flag)
    nxt = args[i + 1] if i + 1 < len(args) else None
    return True if nxt is None or nxt.startswith("--") else nxt


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


GATE_OPS = {"<": lambda a, b: a < b, ">": lambda a, b: a > b,
            "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b,
            "==": lambda a, b: a == b}


def gate_bound(summary, bound):
    """A gate's bound on a summary: a number, or (f, key) for
    f * summary[key]."""
    if isinstance(bound, tuple):
        f, key = bound
        return None if summary[key] is None else f * summary[key]
    return bound


def gate_text(key, op, bound):
    if isinstance(bound, tuple):
        bound = f"{bound[0]} * {bound[1]}"
    return f"{key} {op} {bound}"


def gate_results(summary, gates):
    """[(key, op, bound, value, passed)] of a run's summary against
    gates; bound as written in the gate."""
    out = []
    for key, op, bound in gates:
        v, b = summary[key], gate_bound(summary, bound)
        ok = v is not None and b is not None and GATE_OPS[op](v, b)
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


T_START = time.perf_counter()


def phase(name, **kv):
    """One phase line; t_s is the seconds since the script started."""
    print(json.dumps({"phase": name, "t_s": round(
        time.perf_counter() - T_START, 1), **kv}), flush=True)


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


# The integer counts of a run, held inside a spread with no band.
COUNT_KEYS = ("frames", "failed", "track_failed_frames", "relocalizations",
              "ba_solves")


def spread_band(key, end):
    """Phase 8's band about a spread's nearer end `end`: rmse relative
    (JAX_BAND), recall and coverage absolute (JAX_BAND), ATE 25 % of the
    end (at least 1e-3 m), the counts none, any other metric (RPE) 25 %
    of the end."""
    if key in COUNT_KEYS:
        return 0
    if key == "idepth_rmse":
        return JAX_BAND[key] * end
    if key in JAX_BAND:
        return JAX_BAND[key]
    if key == "ate_rmse":
        return max(0.25 * end, 1e-3)
    return 0.25 * abs(end)


def outside_spread(vals, spread=None):
    """The metrics of vals that lie outside spread_band about their
    spread (JAX_TRACK_BA_SPREAD unless given: key -> (min, max) over the
    JAX package's runs), each with its value and the spread."""
    spread = JAX_TRACK_BA_SPREAD if spread is None else spread
    out = {}
    for k, v in vals.items():
        lo, hi = spread[k]
        end = min(max(v, lo), hi)
        if not abs(v - end) <= spread_band(k, end):
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
    4's 60 frames and each distinct sequence of ACCEPT_RUNS and
    TRACK_ACCEPT_RUNS at 200), as
    frame digests made by cpu_frame_digests in a process of its own,
    which runs beside the card's phases on `threads` cores, in the order
    phase 14 asks for them. The JAX package's runs that phases 9, 13, 14
    and 15 are held to read these frames."""

    def __init__(self, out, threads=4):
        import multiprocessing
        self.dir = os.path.join(out, "cpu_frames")
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir)
        scenes = {}
        for kw in ([accept_sequence(n) for n in ACCEPT_RUNS]
                   + [track_sequence(n) for n in TRACK_ACCEPT_RUNS]):
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


# The TPU v4 kernel's slab budgets (flame_ros_tpu/ops/raster_pallas.py:
# 391-392, :438): short candidates a tile of 2 rows, long triangles.
V4_DEFAULTS = {"cand_s": 384, "cand_l": 128, "long_thresh": 48.0}


def v4_budgets_hold(rc, args, H):
    """Whether the TPU v4 kernel's slab budgets would hold on this mesh,
    from the port's setup; the JAX wrapper runs v2 where they do not
    (flame_ros_tpu/ops/raster_pallas.py:438)."""
    _, lo_pos, hi_pos, counts = rc.v4_setup(
        *args, height=H, row_tile=2, long_thresh=V4_DEFAULTS["long_thresh"])
    n_short, n_live = counts.tolist()
    return (int((hi_pos - lo_pos).max()) <= V4_DEFAULTS["cand_s"]
            and n_live - n_short <= V4_DEFAULTS["cand_l"])


def track_summary(res, node):
    """A tracking run's unrounded summary, in the JAX reference's keys."""
    import numpy as np
    out = {"frames": res.frames_processed, "failed": res.frames_failed,
           "idepth_rmse": res.mean_rmse, "precision": res.mean_precision,
           "recall": res.mean_recall, "coverage": res.final_coverage,
           "ate_rmse": res.ate_rmse, "ate_rmse_sim3": res.ate_rmse_sim3,
           "gt_path_length": res.gt_path_length,
           "rpe_trans_rmse": res.rpe_trans_rmse,
           "rpe_rot_rmse_deg": res.rpe_rot_rmse_deg,
           "rpe30_trans_rmse": res.rpe30_trans_rmse,
           "rpe30_rot_rmse_deg": res.rpe30_rot_rmse_deg,
           "track_failed_frames": res.track_failed_frames,
           "relocalizations": res.relocalizations}
    if node.ba_refine:
        out["ba_solves"] = len(node.ba_costs)
    return {k: (float(v) if isinstance(v, (float, np.floating)) else v)
            for k, v in out.items()}


def v4_timing(rc, args, H, W):
    """v4 on one raster's inputs: the wrapper, the kernel alone (one
    launch between two events; back to back on the card) and the plain
    version (CUDA-event medians, ms), its bound and whether the TPU v4's
    budgets would hold."""
    import torch
    bare = bare_launch(rc, "v4", args, H, W, {})
    b_ops = (bbox_pairs(torch, *args, H, W) * INSTR_PER_TEST["v4"]
             / F32_INSTR_RATE * 1e3)
    b_bytes = (bare.slab_bytes + H * W * 4) / PEAK_BYTES * 1e3
    return dict(
        triangles=int(args[1].shape[0]), vertices=int(args[0].shape[0]),
        live_triangles=int(args[2].sum()),
        ms=cuda_median_ms(lambda: rc.rasterize_tri_ids_v4(
            *args, height=H, width=W)),
        kernel_only_ms=cuda_median_ms(bare), kernel_device_ms=device_ms(bare),
        plain_ms=cuda_median_ms(lambda: rc.rasterize_tri_ids_v4_ref(
            *args, height=H, width=W), reps=5, warmup=1),
        bound_ms=max(b_ops, b_bytes),
        bound_by="operations" if b_ops >= b_bytes else "bytes",
        tpu_v4_budgets_hold=v4_budgets_hold(rc, args, H))


def track_acceptance_run(name, device, out_dir):
    """One run of TRACK_ACCEPT_RUNS through the port's CLI, `offline_runner.
    main --pose-source tracking`, on `device` (the frames render there).
    The runner's frames are tapped for their frame_digest (before any
    occlusion) and its `run_offline_tracking` gets a nodelet of ours,
    whose `_process` is timed on the host clock (to the end of its stats
    read) and counts v4's launches per frame. The id buffer is recomputed
    (check_idmap) after the update of the first non-poseframe from frame
    ACCEPT_CHECK["frame"] on, and of the first poseframe from engine frame
    ACCEPT_CHECK["poseframe"] on (after its install). Every
    hybrid_bundle_adjust call's point count is kept (and the sharded
    solver's) with the frame it follows; on the card also its CUDA-event
    ms, and one more call at the last inputs gives its device launches and
    busy ms. Returns a dict: the summary, the trajectory's poses, the BA
    costs, ms per frame, launches, work, the checks, the digests and the
    second check's raster inputs (check_args)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from flame_ros_torch.frontends import nodelet as nodelet_mod
    from flame_ros_torch.frontends import offline_runner
    from flame_ros_torch.frontends.nodelet import FlameNodelet
    from flame_ros_torch.ops import raster_cuda as rc
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    run_dir = os.path.join(out_dir, name)
    os.makedirs(run_dir, exist_ok=True)
    argv = track_argv(name) + ["--device", str(dev), "--out", run_dir]
    digests, ms, per_frame, checks, held = [], {}, {}, [], {}
    solves, sharded, solve_frames = [], [], []
    orig_build = offline_runner._build_frames
    orig_track = offline_runner.run_offline_tracking
    orig_hb = nodelet_mod.hybrid_bundle_adjust
    orig_sh = nodelet_mod.hybrid_bundle_adjust_sharded
    timer = CallTimer(nodelet_mod, "hybrid_bundle_adjust") if cuda else None

    def spy_hb(*a, **kw):
        solves.append(int(a[5].shape[0]))
        solve_frames.append(int(held["node"].trajectory[-1][0]))
        return (timer or orig_hb)(*a, **kw)

    def spy_sh(*a, **kw):
        sharded.append(int(a[6].shape[0]))
        return orig_sh(*a, **kw)

    def build(args, device):
        frames, cam = orig_build(args, device)

        def tap():
            for f in frames:
                digests.append(frame_digest(f.gray, f.depth, f.quat,
                                            f.trans))
                yield f
        return tap(), cam

    def check(engine, frame, poseframe):
        t = time.perf_counter()
        n_px, args = check_idmap(engine, frame)
        checks.append({"frame": frame, "poseframe": poseframe,
                       "poseframes_so_far": engine._num_poseframes,
                       "triangles": int(args[1].shape[0]),
                       "order_split_px": n_px})
        held["args"] = args
        return time.perf_counter() - t

    def tracked(frames, cam, params, device=None, **kw):
        node = FlameNodelet(cam, params, pose_source="tracking",
                            ba_refine=kw.get("ba_refine", False),
                            eval_gt_depth=True, trajectory_cap=0,
                            device=device)
        engine = node.engine
        held["node"] = node
        process, update = node._process, engine.update
        skip = {}

        def timed(frame):
            mark = rc.rasterize_tri_ids_v4.launches
            i = frame.img_id
            t0 = time.perf_counter()
            process(frame)
            ms[i] = (time.perf_counter() - t0 - skip.pop(i, 0.0)) * 1e3
            per_frame[i] = rc.rasterize_tri_ids_v4.launches - mark

        def checked(t, img_id, *a, **kw):
            # Tracking mode updates directly (track, a poseframe's
            # install, smooth), so after an update the state holds the
            # inputs of its raster; the check's seconds come off the frame.
            pf = engine._num_poseframes
            ok = update(t, img_id, *a, **kw)
            is_pf = engine._num_poseframes != pf
            if ok and (len(checks) == 0 and not is_pf
                       and img_id >= ACCEPT_CHECK["frame"]
                       or len(checks) == 1 and is_pf
                       and engine._frame_count - 1
                       >= ACCEPT_CHECK["poseframe"]):
                skip[img_id] = check(engine, int(img_id), is_pf)
            return ok

        node._process, engine.update = timed, checked
        return orig_track(frames, cam, params, device=device, node=node,
                          **kw)

    rc.reset_counters()
    line = io.StringIO()
    offline_runner._build_frames = build
    offline_runner.run_offline_tracking = tracked
    nodelet_mod.hybrid_bundle_adjust = spy_hb
    nodelet_mod.hybrid_bundle_adjust_sharded = spy_sh
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(line):
            res = offline_runner.main(argv)
    finally:
        offline_runner._build_frames = orig_build
        offline_runner.run_offline_tracking = orig_track
        nodelet_mod.hybrid_bundle_adjust = orig_hb
        nodelet_mod.hybrid_bundle_adjust_sharded = orig_sh
    seconds = time.perf_counter() - t0
    launches, work = launch_counts(rc, dev) if cuda else (
        {"v4": rc.rasterize_tri_ids_v4.launches,
         "v2": rc.rasterize_tri_ids_v2.launches,
         "v3": rc.rasterize_tri_ids_v3.launches}, None)
    printed = json.loads(line.getvalue().strip().splitlines()[-1])
    node = held["node"]
    ids = [int(i) for i, _, _ in node.trajectory]
    poses = [[i] + p.q.detach().cpu().numpy().ravel().tolist()
             + p.t.detach().cpu().numpy().ravel().tolist()
             for i, _, p in node.trajectory]
    steady = [ms[i] for i in ids[5:]]
    out = {"run": name, "argv": argv[:-4], "printed": printed,
           "summary": track_summary(res, node), "poses": poses,
           "ba_costs": list(node.ba_costs), "ba_frames": solve_frames,
           "ba_points": solves,
           "ba_sharded_points": sharded, "digests": digests,
           "ms_per_frame_p50": float(np.percentile(steady, 50)),
           "ms_per_frame_p95": float(np.percentile(steady, 95)),
           "seconds": seconds, "launches": launches, "work": work,
           "v4_launches_min_tracked_frame": min(per_frame[i] for i in ids),
           "checks": checks}
    if timer is not None and timer.events:
        hms = timer.ms()
        hargs, hkw = timer.last
        events, busy = device_events(lambda: orig_hb(*hargs, **hkw))
        out["hybrid_ba"] = dict(
            calls=len(hms), ms_p50=float(np.percentile(hms, 50)),
            ms_max=max(hms),
            host_ms_p50=float(np.percentile(timer.host_s, 50)) * 1e3,
            launches_per_call=events, device_busy_ms_per_call=busy)
    out["check_args"] = held.get("args")
    assert printed["frames"] == out["summary"]["frames"], out["summary"]
    assert len(digests) == ACCEPT_FRAMES, len(digests)
    assert [c["poseframe"] for c in checks] == [False, True], checks
    K = node.engine.params.engine.max_keyframes
    assert checks[1]["poseframes_so_far"] > 3 * K, checks
    # Both id buffers at the configuration's full triangle count.
    T = node.engine.params.engine.max_triangles
    assert [c["triangles"] for c in checks] == [T, T], (T, checks)
    if cuda:
        # v4 on every tracked frame, the device's own count agreeing, v2
        # and v3 never.
        assert out["v4_launches_min_tracked_frame"] >= 1, per_frame
        assert launches["v2"] == 0 and launches["v3"] == 0, launches
        assert work == {"v4": launches["v4"], "v2": 0, "v3": 0}, work
    else:
        assert launches == {"v4": 0, "v2": 0, "v3": 0}, launches
    return out


def track_verdict(name, r):
    """A tracking acceptance run `r` (track_acceptance_run) against the
    JAX package's runs of its frames: on every frame before the parting
    frame, its pose no further from the unmoved run's (JAX_TRACK_ACCEPT)
    than the perturbed runs' poses are there, plus TRACK_BA_POSE_TOL; with
    BA its first three costs within
    TRACK_BA_COST_TOL relative of the JAX runs' smallest and largest of
    each (the unmoved run's where they agree); rmse, recall, coverage,
    ATE, RPE and the solves within spread_band about the spread of the
    unmoved and perturbed runs (JAX_TRACK_ACCEPT_SPREAD); no failed engine
    frame; each
    gate of the JAX test that the unmoved JAX run passes, passed, and the
    metric of each gate it fails held to the spread; pod_dense's solves
    unsharded, at least `solves_min`, each at `ba_points`. Returns
    (verdict dict, ok)."""
    import numpy as np
    spec = TRACK_ACCEPT_RUNS[name]
    ref, spread = JAX_TRACK_ACCEPT[name], JAX_TRACK_ACCEPT_SPREAD[name]
    s = r["summary"]
    got = {int(p[0]): np.asarray(p[1:], np.float64) for p in r["poses"]}
    # Per frame: the distance from the unmoved run's pose, and how far it
    # exceeds the perturbed runs' largest distance there.
    dist = {int(p[0]): (float(np.abs(got[int(p[0])] - np.asarray(p[1:8])).max())
                        if int(p[0]) in got else float("inf"), p[8])
            for p in ref["poses"]}
    pose_diff = max((d for d, _ in dist.values()), default=0.0)
    pose_excess = max((d - m for d, m in dist.values()), default=0.0)
    cost_spread = spread.get("ba_costs", [])
    costs = r["ba_costs"][:len(cost_spread)]
    cost_rel = (max((max(lo / c - 1.0, c / hi - 1.0, 0.0)
                     for c, (lo, hi) in zip(costs, cost_spread)),
                    default=0.0)
                if len(costs) == len(cost_spread) else float("inf"))
    keys = ["idepth_rmse", "recall", "coverage", "ate_rmse",
            "rpe_trans_rmse", "rpe_rot_rmse_deg"]
    if "ba_solves" in ref:
        keys.append("ba_solves")
    port = gate_results(s, spec["gates"])
    jax = gate_results(ref, spec["gates"])
    must = [p for p, j in zip(port, jax) if j[4]]
    held_to = [gate_text(k, op, b) for k, op, b, _, ok in jax if not ok]
    keys += [k for k, _, _, _, ok in jax if not ok and k not in keys]
    outside = outside_spread({k: s[k] for k in keys}, spread)
    failed = [f"{gate_text(k, op, b)}: {v}" for k, op, b, v, ok in must
              if not ok]
    v = {"parting_frame": ref["parting_frame"],
         "poses_checked": len(ref["poses"]), "pose_diff": pose_diff,
         "pose_beyond_jax_runs": pose_excess,
         "costs": costs, "jax_costs": ref.get("ba_costs"),
         "jax_cost_spread": cost_spread,
         "cost_rel_diff": cost_rel, "outside_jax_spread": outside,
         "gates_passed_by_jax": [gate_text(k, op, b)
                                 for k, op, b, *_ in must],
         "gates_failed": failed, "held_to_jax_run": held_to,
         "jax_route": {"devices": ref["jax_devices"],
                       **ref["ba_route"]},
         "port_route": {"unsharded": {"solves": len(r["ba_points"]),
                                      "points": sorted(set(r["ba_points"]))},
                        "sharded": {"solves": len(r["ba_sharded_points"]),
                                    "points": sorted(set(
                                        r["ba_sharded_points"]))}}}
    ok = (pose_excess <= TRACK_BA_POSE_TOL and cost_rel <= TRACK_BA_COST_TOL
          and not outside and not failed and s["failed"] == 0)
    if "solves_min" in spec:
        v["solves_at_budget"] = (
            not r["ba_sharded_points"]
            and len(r["ba_points"]) >= spec["solves_min"]
            and set(r["ba_points"]) == {spec["ba_points"]})
        ok = ok and v["solves_at_budget"]
    return v, ok


# Phase 15's runs, over four processes on the one card: each run is
# bound by the host's launches (tracking ~12k a frame, BA ~16k a solve),
# and one after the other they take ~650 s. The first part runs in the
# script's own process.
TRACK_PARTS = (("pod_dense", "occlusion"), ("easy_ba", "mav"),
               ("rotation_ba", "low_texture"), ("easy", "rotation"))


def track_runs(names, device, out_dir, path=None):
    """track_acceptance_run of each of names in turn. With path (a process
    of its own), the results go to that JSON file instead, without their
    check_args."""
    if path is not None:
        sys.path.insert(0, REPO)
    out = {name: track_acceptance_run(name, device, out_dir)
           for name in names}
    if path is None:
        return out
    for r in out.values():
        r.pop("check_args")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


def tracking_acceptance_path(dev, out, smi, cpu_frames):
    """Phase 15: the eight runs of TRACK_ACCEPT_RUNS on the card, split
    over TRACK_PARTS (four at a time), each reading the CPU's frames bit
    for bit and held to the JAX package's runs of those frames by
    track_verdict; then v4 timed alone on the pod-dense run's second id
    check (T = 32768). Each run's result, its poses and verdict included,
    is written to <out>/track_accept/<run>.json."""
    import multiprocessing
    from flame_ros_torch.datasets.synthetic import VGA
    from flame_ros_torch.ops import raster_cuda as rc
    t_phase = time.perf_counter()
    root = os.path.join(out, "track_accept")
    assert sorted(n for p in TRACK_PARTS for n in p) == sorted(
        TRACK_ACCEPT_RUNS)
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for k, part in enumerate(TRACK_PARTS[1:]):
        path = os.path.join(out, f"track_part{k + 1}.json")
        if os.path.exists(path):
            os.remove(path)
        proc = ctx.Process(target=track_runs, args=(part, str(dev), root,
                                                    path))
        proc.start()
        procs.append((proc, path))
    runs = track_runs(TRACK_PARTS[0], dev, root)
    for proc, path in procs:
        proc.join()
        if proc.exitcode != 0:
            raise RuntimeError(f"phase 15 process of {path} ended with "
                               f"code {proc.exitcode}")
        with open(path) as f:
            runs.update(json.load(f))
    t_runs = time.perf_counter() - t_phase
    pod = runs["pod_dense"]
    v4 = v4_timing(rc, pod.pop("check_args"), VGA.height, VGA.width)
    fails = []
    for name in TRACK_ACCEPT_RUNS:
        r = runs[name]
        r.pop("check_args", None)
        verdict, ok = track_verdict(name, r)
        t1 = time.perf_counter()
        differ = frames_differ(r["digests"], cpu_frames.digests(
            ACCEPT_FRAMES, track_sequence(name)))
        same = not any(differ.values())
        with open(os.path.join(root, name + ".json"), "w") as f:
            json.dump(dict(r, verdict=verdict, frames_differ=differ), f)
        phase("tracking_acceptance", run=name, card=smi, ok=ok and same,
              verdict=verdict, frames_equal_cpu=same, frames_differ=differ,
              cpu_frames_wait_s=time.perf_counter() - t1,
              jax_test=TRACK_ACCEPT_RUNS[name]["test"],
              runs_at_a_time=len(TRACK_PARTS),
              **({"v4_pod_density": v4} if name == "pod_dense" else {}),
              **{k: r[k] for k in r if k not in ("run", "digests", "poses")})
        if not (ok and same):
            fails.append(name)
    phase("tracking_acceptance_total", card=smi, runs=len(runs),
          v4_launches={k: r["launches"]["v4"] for k, r in runs.items()},
          runs_seconds=t_runs, seconds=time.perf_counter() - t_phase)
    assert not fails, f"tracking runs outside the JAX runs: {fails}"
    return runs, v4


@functools.lru_cache(maxsize=None)
def repo_script(name):
    """scripts/<name>.py of the repository as a module, loaded once."""
    import importlib.util
    path = os.path.join(REPO, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def streaming_script():
    """scripts/chip_acc_streaming_torch.py, the port's streaming
    acceptance protocol, as a module."""
    return repo_script("chip_acc_streaming_torch")


def stream_verdict(row, ref):
    """A streaming run's row against the JAX package's pinned run of the
    same frames, `ref` (JAX_STREAM_ACCEPT): each key of STREAM_BAND
    within its band (rmse relative) and, where the run took the pinned
    schedule (no stale window, no superseded topology), within
    STREAM_TIGHT relative; STREAM_EQUAL equal; every gate that the JAX
    run passes passed. Returns (verdict, ok)."""
    diff = {k: abs(row[k] - ref[k]) / (ref[k] if k == "idepth_rmse" else 1.0)
            for k in STREAM_BAND}
    rel = {k: abs(row[k] - ref[k]) / abs(ref[k]) for k in STREAM_BAND}
    in_band = all(diff[k] <= STREAM_BAND[k] for k in diff)
    took_pinned = row["stale_tri_windows"] == 0 and row["tri_superseded"] == 0
    in_tight = all(r <= STREAM_TIGHT for r in rel.values())
    unequal = {k: (row[k], ref[k]) for k in STREAM_EQUAL if row[k] != ref[k]}
    jax_gates = streaming_script().gate_results(ref)
    failed = [g for g, ok in jax_gates.items() if ok and not row["gates"][g]]
    v = {"band_diff": diff, "in_band": in_band, "rel_diff": rel,
         "in_tight": in_tight, "tight_applies": took_pinned,
         "unequal": unequal,
         "gates_passed_by_jax": [g for g, ok in jax_gates.items() if ok],
         "gates_failed": failed,
         "jax": {k: ref[k] for k in (*STREAM_BAND, *STREAM_EQUAL)}}
    return v, (in_band and (in_tight or not took_pinned) and not unequal
               and not failed)


def perframe_steady_recall(telemetry):
    """steady_recall (the protocol's last-150 mean) of a per-frame run
    from its telemetry.jsonl; None without the file."""
    import numpy as np
    from flame_ros_torch.models.engine import DEVICE_STATS_KEYS
    if not os.path.exists(telemetry):
        return None
    with open(telemetry) as f:
        recs = [json.loads(line) for line in f]
    rows = np.asarray([[r[k] for k in DEVICE_STATS_KEYS] for r in recs])
    return streaming_script().summarize([rows], DEVICE_STATS_KEYS,
                                        len(recs))["steady_recall"]


def streaming_acceptance_path(dev, out, smi, cpu_frames):
    """Phase 16: the streaming acceptance protocol
    (scripts/chip_acc_streaming_torch.py) on the card over phase 14's
    default frames, each equal to the CPU's. (a) the free run (the
    product): its six gates, 200 frames, none failed, every frame
    healthy, v4 launched on every frame (its wrapper's count read after
    each frame's smooth step) and v2 and v3 never, the device work
    counters agreeing, the id buffer of window STREAM_CHECK_WINDOW's last
    frame equal to plain v4's recomputation; (b) every stats row read
    asynchronously equal bit for bit to its window's tensor read after a
    full synchronize; (c) the pinned run of the same frames, its launches
    counted as the free run's: where the free run counted no stale window
    and no superseded topology (it took the pinned schedule), every stats
    row and every final state leaf equal bit for bit; otherwise the
    counts recorded; (d) the pinned run held to JAX_STREAM_ACCEPT by
    stream_verdict, and the tight band's control (see STREAM_TIGHT)
    outside it. Prints fps, latency, ms/frame, host
    Delaunay ms per poseframe and the install counters of both runs, and
    steady recall beside phase 14's per-frame run of the same frames.
    Returns the free run's wrapper launch counts."""
    import types
    import numpy as np
    import torch
    from flame_ros_torch.datasets.synthetic import VGA, make_sequence
    from flame_ros_torch.models import engine as engine_mod
    from flame_ros_torch.models.engine import state_to_numpy
    from flame_ros_torch.ops import raster_cuda as rc
    sa = streaming_script()
    t_phase = time.perf_counter()
    seq = make_sequence(ACCEPT_FRAMES, VGA, device=dev,
                        **accept_sequence("default"))
    digests = sequence_digests(seq)
    frames, gt = sa.sequence_frames(seq, ACCEPT_FRAMES)
    del seq
    t_render = time.perf_counter() - t_phase
    smooth = engine_mod._smooth_step

    def counted_run(schedule, after_window=None):
        """One streamed run from counters at 0, v4's count read after each
        frame's smooth step (host counters: no sync). Returns the run,
        v4's launches per frame, and the wrapper and device counts."""
        marks = []

        def counted(*args, **kw):
            res = smooth(*args, **kw)
            marks.append(rc.rasterize_tri_ids_v4.launches)
            return res

        rc.reset_counters()
        engine_mod._smooth_step = counted
        try:
            run = sa.stream_acceptance(frames, gt, dev, schedule,
                                       after_window=after_window)
        finally:
            engine_mod._smooth_step = smooth
        launches, work = launch_counts(rc, dev)
        return run, np.diff([0] + marks), launches, work

    def kernels_ok(per_frame, launches, work):
        return (len(per_frame) == ACCEPT_FRAMES and int(per_frame.min()) >= 1
                and launches["v2"] == 0 and launches["v3"] == 0
                and work == {"v4": launches["v4"], "v2": 0, "v3": 0})

    # (a) the free run, the state held after the check window.
    held = {}

    def hold(k, engine):
        if k == STREAM_CHECK_WINDOW:
            held.update(engine=types.SimpleNamespace(
                cam=engine.cam, params=engine.params, state=engine.state),
                frame=engine._frame_count - 1,
                poseframes=sum(f[4] for f in frames[:engine._frame_count]))

    free, free_pf, launches, work = counted_run("free", hold)
    n_px, _ = check_idmap(held["engine"], held["frame"])
    K = free.engine.params.engine.max_keyframes
    health = [float(h) for a in free.rows for h in
              a[:, engine_mod.DEVICE_STATS_KEYS.index("health")]]

    # (b) the async reads against the same tensors read after a sync.
    torch.cuda.synchronize()
    async_differ = [k for k, (a, t) in enumerate(zip(free.rows,
                                                     free.tensors))
                    if a.tobytes() != t.cpu().numpy().tobytes()]

    # (c) the pinned schedule on the same frames.
    pinned, pinned_pf, p_launches, p_work = counted_run("pinned")
    took_pinned = (free.row["stale_tri_windows"] == 0
                   and free.row["tri_superseded"] == 0)
    rows_differ = [k for k, (a, b) in enumerate(zip(free.rows, pinned.rows))
                   if a.tobytes() != b.tobytes()]
    fs, ps = state_to_numpy(free.engine.state), state_to_numpy(
        pinned.engine.state)
    leaves_differ = [k for k in ps if fs[k].tobytes() != ps[k].tobytes()]

    # (d) the pinned run against the JAX package's pinned run, and the
    # tight band's control: the pinned run with the filter's posterior
    # means rounded to bfloat16 after each window.
    verdict, ok_jax = stream_verdict(pinned.row, JAX_STREAM_ACCEPT)

    def mu_bf16(k, engine):
        f = engine.state.feat
        engine.state = engine.state._replace(
            feat=f._replace(mu=f.mu.bfloat16().float()))

    control = sa.stream_acceptance(frames, gt, dev, "pinned",
                                   after_window=mu_bf16)
    control_verdict, _ = stream_verdict(control.row, JAX_STREAM_ACCEPT)
    differ = frames_differ(digests, cpu_frames.digests(
        ACCEPT_FRAMES, accept_sequence("default")))
    same = not any(differ.values())
    checks = {
        "free_passes_gates": free.row["pass"],
        "frames_200_none_failed": (free.row["frames"] == ACCEPT_FRAMES
                                   and free.row["frames_failed"] == 0
                                   and free.row["failed_windows"] == 0),
        "healthy": len(health) == ACCEPT_FRAMES and min(health) == 1.0,
        "v4_every_frame_no_v2_v3": kernels_ok(free_pf, launches, work),
        "pinned_v4_every_frame_no_v2_v3": kernels_ok(pinned_pf, p_launches,
                                                     p_work),
        "idmap_past_third_wrap": held["poseframes"] > 3 * K,
        "async_reads_equal_synced": not async_differ,
        "frames_equal_cpu": same,
        "free_equals_pinned": (not rows_differ and not leaves_differ)
        if took_pinned else None,
        "pinned_held_to_jax": ok_jax,
        "tight_band_sees_bf16_mu": not control_verdict["in_tight"]}
    keys = ("fps", "latency_ms_p50", "latency_ms_p95", "ms_per_frame_p50",
            "ms_per_frame_p95", "gt_prestage_s", "tri_host_ms_per_poseframe",
            "topo_installs", "stale_tri_windows", "tri_superseded",
            "tri_dropped", "idepth_rmse", "precision", "recall",
            "steady_recall", "steady_coverage", "final_coverage",
            "frames_evaluated", "gates")
    phase("streaming_acceptance", card=smi,
          ok=all(v is not False for v in checks.values()), checks=checks,
          free={k: free.row[k] for k in keys},
          pinned={k: pinned.row[k] for k in keys},
          free_took_pinned_schedule=took_pinned,
          rows_differ_from_pinned=rows_differ,
          leaves_differ_from_pinned=leaves_differ, verdict=verdict,
          bf16_mu_control={"rel_diff": control_verdict["rel_diff"],
                        "in_tight": control_verdict["in_tight"],
                        "in_band": control_verdict["in_band"],
                        "pass": control.row["pass"]},
          perframe_steady_recall=perframe_steady_recall(os.path.join(
              out, "accept", "default", "telemetry.jsonl")),
          launches={"free": launches, "pinned": p_launches},
          work={"free": work, "pinned": p_work},
          v4_per_frame_min={"free": int(free_pf.min()),
                            "pinned": int(pinned_pf.min())},
          idmap_check={"window": STREAM_CHECK_WINDOW,
                       "frame": held["frame"],
                       "poseframes_so_far": held["poseframes"],
                       "order_split_px": n_px},
          async_differ=async_differ, frames_differ=differ,
          render_s=t_render, seconds=time.perf_counter() - t_phase)
    failed = [k for k, v in checks.items() if v is False]
    assert not failed, f"streaming acceptance failed: {failed}"
    return launches


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

    # 15. the tracking-mode acceptance protocol --------------------------
    tracking_acceptance_path(dev, OUT, smi, cpu_frames)

    # 16. the streaming acceptance protocol -------------------------------
    launches16 = streaming_acceptance_path(dev, OUT, smi, cpu_frames)
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
            "replaces": replaces[name],
            "launches": launches[name] + launches16[name],
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
