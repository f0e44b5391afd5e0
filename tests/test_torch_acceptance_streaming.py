"""The streaming acceptance protocol of scripts/chip_acc_streaming.py
through the port (scripts/chip_acc_streaming_torch.py), held against the
JAX package.

- `test_protocol_is_the_jax_script`: the port script's protocol constants
  and gates are the JAX script's, read from it with `ast` (200 frames,
  windows of 6, the poseframe rule, prefetch depth 2, in-flight bound 2,
  6 warm windows, the last-150 steady means, the six gate names, their
  comparisons and thresholds): exact equality, no JAX run.
- `test_pinned_stream_matches_jax`: at 96x128 with 256 feature slots and
  4 keyframes, 16 frames streamed as windows of 2 (a poseframe first in
  each, so JAX builds one `_window_step` for the poseframe and one for
  the frame after it) through the script's loop with the pinned schedule
  and asynchronous stats reads, against the JAX package's pinned loop
  (scripts/jax_streaming_reference.py) on the same numpy frames: every
  frame's stats row within 1e-4 (absolute or relative, whichever is
  larger), the install count and the install watermark after every
  window equal, all six gate outcomes equal. The photometric totals
  (PHOTO_TOTALS) are the exception: on a poseframe they sum the errors
  of the new keyframe sampled against itself, ~0.02-0.04 of pure f32
  noise (other frames ~6e4), which the two packages' sample positions
  (f32 noise, ~1e-5 px) move by up to 0.012; they are held to 0.05
  absolute there and 1e-4 relative elsewhere. The NLTGV2 smoothness
  costs (SMOOTHNESS: sums of absolute differences over the edges, which
  cancel) are held to 1e-3 relative, the bound
  tests/test_torch_nodelet.py holds a stream's stats to: on the
  poseframe after the fourth install they differ by 2.1e-4 (at most
  5.8e-5 on every other frame), while the integer counts and the
  installs are equal.
- `test_free_run_equals_pinned_on_cpu`: the same 16 frames with the free
  schedule, in a run that counted no stale window and no superseded
  topology (it took the pinned schedule), equal to the pinned run bit for
  bit: every stats row and every state leaf; each async read equal to its
  tensor read again.
- `test_script_refuses_without_card`: without a card the script raises
  unless given --device cpu.
- `test_stream_verdict_tight_band`: `chip_smoke.stream_verdict` on rows
  made from `chip_smoke.JAX_STREAM_ACCEPT` (no run): a pinned-schedule
  row 3.3e-6 from it (the card's reading) passes; one whose steady recall
  is 1e-3 relative off (inside JAX_BAND, as the bfloat16 control of
  phase 16 is) fails; the same row with a stale window, which no longer
  took the pinned schedule, is held to JAX_BAND only and passes.
- `test_vga200_stream_acceptance` (slow): the VGA/200 free run through
  the script on the card where there is one (the CPU otherwise), held to
  the six gates and to `chip_smoke.JAX_STREAM_ACCEPT` by
  `chip_smoke.stream_verdict` (rmse within 5 % relative, recall, steady
  recall and both coverages within 0.02, precision within 0.02; where
  the run took the pinned schedule each of these within 1e-4 relative,
  STREAM_TIGHT; install count and evaluated frames equal, every gate JAX
  passes passed):

      python -m pytest tests/test_torch_acceptance_streaming.py -m slow -q -s
"""
import ast
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from flame_ros_tpu.config import FlameParams as JParams
from flame_ros_tpu.geometry.camera import Pinhole as JCam
from flame_ros_torch.config import FlameParams as TParams
from flame_ros_torch.datasets.synthetic import make_sequence
from flame_ros_torch.geometry.camera import Pinhole as TCam
from flame_ros_torch.models.engine import DEVICE_STATS_KEYS, state_to_numpy

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
WIN = 2           # frames per window, and the poseframe spacing
N = 16            # frames streamed
JCAM = JCam(105.0, 105.0, 63.5, 47.5, W, H)
TCAM = TCam(105.0, 105.0, 63.5, 47.5, W, H)
SMALL = {"engine": {"max_features": 256, "max_keyframes": 4}}
PHOTO_TOTALS = ("total_photo_error", "avg_photo_error")
SMOOTHNESS = ("nltgv2_total_smoothness_cost", "nltgv2_avg_smoothness_cost")


SA = chip_smoke.streaming_script()
REF = chip_smoke.repo_script("jax_streaming_reference")


@pytest.fixture(scope="module")
def seq():
    s = make_sequence(N, TCAM, motion="strafe", device="cpu")
    imgs = torch.clamp(s.images, 0, 255).to(torch.uint8).numpy()
    return {"images": imgs, "q": s.poses.q.numpy(), "t": s.poses.t.numpy(),
            "stamps": np.asarray(s.timestamps, np.float64),
            "depths": s.depths.numpy()}


def _port_frames(seq):
    from flame_ros_torch.geometry.se3 import SE3
    return [(float(seq["stamps"][i]), i,
             SE3(torch.from_numpy(seq["q"][i]), torch.from_numpy(seq["t"][i])),
             seq["images"][i], i % WIN == 0) for i in range(N)]


def _port_run(seq, schedule):
    wms = []
    run = SA.stream_acceptance(
        _port_frames(seq), seq["depths"], "cpu", schedule, WIN, cam=TCAM,
        params=TParams.from_dict(SMALL),
        after_window=lambda k, e: wms.append(int(e.state.topo_frame_id)))
    return run, wms


@pytest.fixture(scope="module")
def pinned(seq):
    return _port_run(seq, "pinned")


def _const(node):
    return ast.literal_eval(node)


def test_protocol_is_the_jax_script():
    tree = ast.parse(open(os.path.join(
        REPO, "scripts", "chip_acc_streaming.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    assigns = {t.id: n.value for n in ast.walk(main)
               if isinstance(n, ast.Assign) for t in n.targets
               if isinstance(t, ast.Name)}
    # CHIP_ACC_FRAMES defaults to the whole sequence, which is always
    # make_sequence(n_frames=200, cam=VGA).
    env = assigns["n_frames"].args[0]
    assert [_const(a) for a in env.args] == ["CHIP_ACC_FRAMES",
                                             str(SA.FRAMES)]
    mk = assigns["seq"]
    assert mk.func.id == "make_sequence" and not mk.args
    assert {k.arg: k.value for k in mk.keywords}["cam"].id == "VGA"
    assert _const({k.arg: k.value for k in mk.keywords}["n_frames"]) == \
        SA.FRAMES
    assert _const(assigns["win"]) == SA.WINDOW
    assert _const(assigns["max_inflight"]) == SA.MAX_INFLIGHT
    # The poseframe rule: i % 6 == 0 in the window tuples.
    pf = [n for n in ast.walk(main) if isinstance(n, ast.Compare)
          and isinstance(n.left, ast.BinOp) and isinstance(n.left.op, ast.Mod)]
    assert len(pf) == 1 and pf[0].left.left.id == "i"
    assert (_const(pf[0].left.right), _const(pf[0].comparators[0])) == \
        (SA.POSEFRAME_EVERY, 0)
    # Prefetch depth: the windows prefetched before the loop and the
    # distance of the one prefetched inside it.
    first = [n.iter.args[0] for n in ast.walk(main)
             if isinstance(n, ast.For) and isinstance(n.iter, ast.Call)
             and getattr(n.iter.func, "id", "") == "range"
             and len(n.iter.args) == 1
             and isinstance(n.iter.args[0], ast.Constant)]
    assert [_const(a) for a in first] == [SA.PREFETCH_DEPTH]
    nxt = assigns["nxt"]
    assert isinstance(nxt.op, ast.Add) and _const(nxt.right) == \
        SA.PREFETCH_DEPTH
    warm = assigns["n_warm_w"]
    assert warm.func.id == "min" and _const(warm.args[0]) == SA.WARM_WINDOWS
    # The steady means: the last 150 of each series.
    lasts = {n.value.id: _const(n.slice.lower.operand) for n in
             ast.walk(main) if isinstance(n, ast.Subscript)
             and isinstance(n.slice, ast.Slice) and n.slice.lower is not None
             and isinstance(n.slice.lower, ast.UnaryOp)}
    assert lasts == {"recs": SA.STEADY_LAST, "covs": SA.STEADY_LAST}
    # The six gates: name, the quantity compared, comparison, bound.
    quantity = {"np.mean(rmses)": "idepth_rmse",
                "np.mean(precs)": "precision",
                "steady_recall": "steady_recall",
                "engine._tri_dropped": "tri_dropped",
                "len(rmses)": "frames_evaluated", "n_frames": "frames"}
    ops = {ast.Lt: "<", ast.Gt: ">", ast.Eq: "=="}
    gates = []
    for key, value in zip(assigns["gates"].keys, assigns["gates"].values):
        cmp = [n for n in ast.walk(value) if isinstance(n, ast.Compare)
               and type(n.ops[0]) in ops]
        cmp = cmp[-1]
        right = cmp.comparators[0]
        bound = ("frames" if isinstance(right, ast.Name)
                 and right.id == "n_frames" else _const(right))
        gates.append((_const(key), quantity[ast.unparse(cmp.left)],
                      ops[type(cmp.ops[0])], bound))
    assert gates == list(SA.GATES)


def test_pinned_stream_matches_jax(seq, pinned):
    run, wms = pinned
    jwms = []
    jrow, jrows, _ = REF.jax_stream_acceptance(
        REF.jax_frames(seq, WIN), seq["depths"], "pinned", WIN, cam=JCAM,
        params=JParams.from_dict(SMALL),
        after_window=lambda k, e: jwms.append(int(e.state.topo_frame_id)))
    t = np.concatenate(run.rows)
    j = np.concatenate(jrows)
    assert t.shape == j.shape == (N, len(DEVICE_STATS_KEYS))
    for b in range(N):
        for c, k in enumerate(DEVICE_STATS_KEYS):
            tol = dict(rel=1e-3 if k in SMOOTHNESS else 1e-4,
                       abs=0.05 if k in PHOTO_TOTALS else 1e-4)
            assert t[b, c] == pytest.approx(j[b, c], **tol), (b, k)
    assert t[:, DEVICE_STATS_KEYS.index("health")].min() == 1.0
    assert run.row["topo_installs"] == jrow["topo_installs"] == N // WIN - 1
    assert wms == jwms and wms[-1] == N - WIN - 1
    assert run.engine._installed_topo_wm == jrow["installed_topo_wm"]
    assert run.row["gates"] == jrow["gates"]
    for key in ("frames_evaluated", "tri_dropped", "stale_tri_windows",
                "tri_superseded", "poseframes"):
        assert run.row[key] == jrow[key], key


def test_free_run_equals_pinned_on_cpu(seq, pinned):
    ref, ref_wms = pinned
    # The free schedule depends on timing: a run in which a window
    # dispatched before its Delaunay finished takes another schedule and
    # is not comparable. Three tries for one that took the pinned one.
    for _ in range(3):
        run, wms = _port_run(seq, "free")
        if run.row["stale_tri_windows"] == run.row["tri_superseded"] == 0:
            break
    assert run.row["stale_tri_windows"] == 0, run.row
    assert run.row["tri_superseded"] == 0, run.row
    assert wms == ref_wms
    for a, b in zip(run.rows, ref.rows):
        assert a.tobytes() == b.tobytes()
    for a, t in zip(run.rows, run.tensors):
        assert a.tobytes() == t.numpy().tobytes()
    fs, ps = state_to_numpy(run.engine.state), state_to_numpy(
        ref.engine.state)
    assert sorted(fs) == sorted(ps)
    for k in ps:
        assert fs[k].tobytes() == ps[k].tobytes(), k
    assert {k: run.row[k] for k in ("topo_installs", "frames_evaluated")} \
        == {k: ref.row[k] for k in ("topo_installs", "frames_evaluated")}


def test_script_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        SA.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        SA.main(["--device", "cuda", "--schedule", "pinned"])


def test_stream_verdict_tight_band():
    ref = chip_smoke.JAX_STREAM_ACCEPT
    row = dict(ref, gates=SA.gate_results(ref))
    near = dict(row, idepth_rmse=ref["idepth_rmse"] * (1 + 3.3e-6))
    assert chip_smoke.stream_verdict(near, ref)[1]
    off = dict(row, steady_recall=ref["steady_recall"] * (1 - 1e-3))
    verdict, ok = chip_smoke.stream_verdict(off, ref)
    assert verdict["in_band"] and not verdict["in_tight"] and not ok
    assert chip_smoke.stream_verdict(dict(off, stale_tri_windows=1),
                                     ref)[1]


@pytest.mark.slow
def test_vga200_stream_acceptance():
    from flame_ros_torch.datasets.synthetic import VGA
    device = "cuda" if torch.cuda.is_available() else "cpu"
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        s = make_sequence(SA.FRAMES, VGA, device=device,
                          **chip_smoke.accept_sequence("default"))
        frames, gt = SA.sequence_frames(s, SA.FRAMES)
        del s
        run = SA.stream_acceptance(frames, gt, device, "free")
    finally:
        torch.set_num_threads(threads)
    verdict, ok = chip_smoke.stream_verdict(run.row,
                                            chip_smoke.JAX_STREAM_ACCEPT)
    print(json.dumps({"device": device, "row": run.row, "verdict": verdict}))
    assert run.row["pass"], run.row["gates"]
    assert run.row["frames_failed"] == 0
    assert ok, verdict
