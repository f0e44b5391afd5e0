"""The port's multi-stream runner (flame_ros_torch/parallel/
multi_stream.py) held against the JAX package's MultiStreamRunner and
against single engines on the CPU, at 96x128 with 256 feature slots, 4
keyframes and a poseframe every 6th frame: two streams, stream 1 one
frame behind (frames max(i - 1, 0)), 8 frames with GT depth.

One module-scoped JAX runner is the reference for everything that is held
to JAX (its two step signatures, poseframe and frame, compile once): it
writes a checkpoint after frame 6 (index 5) and runs on to frame 8. The
frames are rendered once by the port's renderer as uint8 numpy arrays and
go to both packages.

Tolerances are the lockstep test's (tests/test_torch_engine.py):
integer-valued stats exactly, float stats to 1e-4 absolute plus 1e-5
relative, but the photometric totals to 5 % relative plus 0.01 as in
tests/test_torch_window.py (PHOTO_TOTALS); idepth maps to 1e-4. The port's
runner against single port engines is exact: every state leaf bit for
bit.
"""
import contextlib
import os
import threading
import warnings

import numpy as np
import pytest
import torch

from flame_ros_tpu.config import FlameParams as JParams
from flame_ros_tpu.geometry.camera import Pinhole as JCam
from flame_ros_tpu.geometry.se3 import SE3 as JSE3
from flame_ros_tpu.parallel import multi_stream as jms
from flame_ros_torch.config import FlameParams as TParams
from flame_ros_torch.datasets.synthetic import make_sequence
from flame_ros_torch.geometry.camera import Pinhole as TCam
from flame_ros_torch.geometry.se3 import SE3 as TSE3
from flame_ros_torch.models.engine import (DEVICE_STATS_KEYS, Flame,
                                           state_leaves)
from flame_ros_torch.ops import raster as traster
from flame_ros_torch.ops.pyramid import build_pyramid
from flame_ros_torch.ops import raster_cuda
from flame_ros_torch.parallel import multi_stream as tms

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W = 96, 128
JCAM = JCam(105.0, 105.0, 63.5, 47.5, W, H)
TCAM = TCam(105.0, 105.0, 63.5, 47.5, W, H)
SMALL = {"engine": {"max_features": 256, "max_keyframes": 4},
         "input": {"poseframe_subsample_factor": 6}}
S, N_FRAMES, CKPT_AT = 2, 8, 6
COUNT_KEYS = {"num_feats", "num_vtx", "num_tris", "num_edges",
              "num_idepth_updates", "num_fail_ref_patch_grad",
              "num_fail_ambiguous_match", "num_fail_max_cost",
              "num_fail_max_dropouts", "num_fail_max_var", "num_detections",
              "true_pos", "true_neg", "false_pos", "false_neg", "health"}
PHOTO_TOTALS = ("total_photo_error", "avg_photo_error")


@pytest.fixture(scope="module")
def seq():
    s = make_sequence(N_FRAMES, TCAM, motion="strafe", device="cpu")
    return dict(imgs=torch.clamp(s.images, 0, 255).to(torch.uint8).numpy(),
                depths=s.depths.numpy(), ts=s.timestamps,
                q=s.poses.q.numpy(), t=s.poses.t.numpy())


def _ids(i):
    return [i, max(i - 1, 0)]          # stream 1 one frame behind


def _frames(seq, i, se3):
    return [(float(seq["ts"][k]), k, se3(seq["q"][k], seq["t"][k]),
             seq["imgs"][k]) for k in _ids(i)]


def _jse3(q, t):
    return JSE3(np.asarray(q), np.asarray(t))


def _tse3(q, t):
    return TSE3(torch.from_numpy(q), torch.from_numpy(t))


def _gt(seq, i):
    return np.stack([seq["depths"][k] for k in _ids(i)])


def _runner(**kw):
    return tms.MultiStreamRunner(TCAM, S, params=TParams.from_dict(SMALL),
                                 device="cpu", **kw)


@contextlib.contextmanager
def _no_vmap_fallback():
    """Every op under torch.func.vmap must have a batching rule: torch's
    "performance drop" warning of its per-sample fallback raises."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        torch._C._functorch._set_vmap_fallback_warning_enabled(True)
        try:
            yield
        finally:
            torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def _drive(runner, seq, lo, hi, se3=_tse3):
    stats = []
    for i in range(lo, hi):
        assert runner.update(_frames(seq, i, se3), gt_depths=_gt(seq, i))
        stats.append(runner.flush_stats())
    return stats


@pytest.fixture(scope="module")
def jax_run(seq, tmp_path_factory):
    """The JAX runner over the 8 frames, its checkpoint after frame 6."""
    r = jms.MultiStreamRunner(JCAM, num_streams=S,
                              params=JParams.from_dict(SMALL))
    stats = _drive(r, seq, 0, CKPT_AT, _jse3)
    ckpt = r.save_checkpoint(str(tmp_path_factory.mktemp("jax") / "ms"))
    stats += _drive(r, seq, CKPT_AT, N_FRAMES, _jse3)
    return dict(stats=stats, maps=r.get_idepth_maps(),
                meshes=r.get_meshes(), ckpt=ckpt)


@pytest.fixture(scope="module")
def port_run(seq):
    r = _runner()
    stats = _drive(r, seq, 0, N_FRAMES)
    return r, stats


def _assert_stats(got, want, what):
    for k in DEVICE_STATS_KEYS:
        if k in COUNT_KEYS:
            assert got[k] == want[k], (what, k)
        else:
            tol = (dict(rel=0.05, abs=0.01) if k in PHOTO_TOTALS
                   else dict(rel=1e-5, abs=1e-4))
            assert got[k] == pytest.approx(want[k], **tol), (what, k)


def _assert_runs(stats, maps, meshes, ref, what):
    for i, (rows, jrows) in enumerate(zip(stats, ref["stats"])):
        for s in range(S):
            _assert_stats(rows[s], jrows[s], f"{what}: frame {i} stream {s}")
    np.testing.assert_allclose(maps, ref["maps"], atol=1e-4, equal_nan=True)
    for (uv, x, tris), (juv, jx, jtris) in zip(meshes, ref["meshes"]):
        np.testing.assert_array_equal(tris, jtris)
        np.testing.assert_allclose(uv, juv, atol=1e-4)
        np.testing.assert_allclose(x, jx, atol=1e-4, rtol=1e-5)


def test_runner_matches_jax_runner(port_run, jax_run):
    """Per-frame stats of each stream, the last in-dispatch idepth maps
    and get_meshes against the JAX runner over the same frames."""
    r, stats = port_run
    assert r.get_idepth_maps().shape == (S, H, W)
    _assert_runs(stats, r.get_idepth_maps(), r.get_meshes(), jax_run,
                 "runner")
    assert [len(m[2]) for m in r.get_meshes()] == \
        [len(m[2]) for m in jax_run["meshes"]]


def test_runner_streams_equal_single_engines(seq, port_run):
    """Stream by stream, the runner computes what a single CPU engine fed
    that stream's frames (same poseframe schedule) computes: every
    EngineState leaf bit for bit after each frame, and each frame's stats.
    The topology watermark is the runner's, the largest frame id any
    stream has dispatched (as in the JAX runner), so stream 1's is stream
    0's."""
    runner = _runner()
    singles = [Flame(W, H, cam=TCAM, params=TParams.from_dict(SMALL),
                     device="cpu") for _ in range(S)]
    for i in range(N_FRAMES):
        frames = _frames(seq, i, _tse3)
        with _no_vmap_fallback():
            assert runner.update(frames, gt_depths=_gt(seq, i))
        rows = runner.flush_stats()
        for s, eng in enumerate(singles):
            assert eng.update(*frames[s], is_poseframe=i % 6 == 0,
                              gt_depth=seq["depths"][frames[s][1]])
            assert rows[s] == eng.flush_stats(), (i, s)
            leaves = list(zip(state_leaves(eng.state),
                              state_leaves(runner.states)))
            leaves[-1] = (singles[0].state.topo_frame_id, leaves[-1][1])
            for j, (a, b) in enumerate(leaves):
                assert torch.equal(a, b[s]), (i, s, j)
    # batched_frame_step (an ordinary frame from given pyramids, no GT)
    # against batched_full_step on the same frame.
    imgs = torch.from_numpy(np.stack([f[3] for f in frames]))
    meta = torch.from_numpy(np.stack([np.concatenate(
        [f[2].q.numpy(), f[2].t.numpy(), [f[1], 0.0, 0.0]])
        for f in frames]).astype(np.float32))
    full, maps, stats = tms.batched_full_step(
        runner.states, imgs, meta, None, cam=TCAM, params=runner.params,
        is_pf=False, kf_slot=0)
    pyrs = torch.func.vmap(lambda im: build_pyramid(
        im.to(torch.float32), 3))(imgs)
    part, maps2, cov = tms.batched_frame_step(
        runner.states, pyrs, meta[:, :4], meta[:, 4:7],
        meta[:, 7].to(torch.int32), cam=TCAM, params=runner.params)
    for a, b in zip(state_leaves(full), state_leaves(part)):
        assert torch.equal(a, b)
    assert torch.equal(maps.isnan(), maps2.isnan())
    assert torch.equal(cov, stats[:, DEVICE_STATS_KEYS.index("coverage")])


def test_checkpoint_from_jax_runner(seq, jax_run, tmp_path):
    """A checkpoint the JAX runner wrote after frame 6, loaded by the
    port's runner and run on to frame 8, against the JAX runner run on;
    the port's own checkpoint is published atomically and loads back bit
    for bit; a runner with other capacities refuses it. A device list
    mixing CPU and CUDA, and spatial_parts > 1 without a part layout,
    raise."""
    r = _runner()
    r.load_checkpoint(jax_run["ckpt"])
    assert (r._frame_count, r._num_poseframes) == (CKPT_AT, 1)
    stats = _drive(r, seq, CKPT_AT, N_FRAMES)
    ref = dict(jax_run, stats=jax_run["stats"][CKPT_AT:])
    _assert_runs(stats, r.get_idepth_maps(), r.get_meshes(), ref, "resumed")

    path = str(tmp_path / "port")
    fn = r.save_checkpoint(path)
    assert fn == path + ".npz" and os.path.exists(fn)
    assert not os.path.exists(fn + ".tmp")
    back = _runner()
    back.load_checkpoint(fn)
    for a, b in zip(state_leaves(r.states), state_leaves(back.states)):
        assert torch.equal(a, b)
    assert back._max_frame_id == r._max_frame_id == N_FRAMES - 1
    other = tms.MultiStreamRunner(
        TCAM, S, params=TParams.from_dict(
            {**SMALL, "engine": {"max_features": 128, "max_keyframes": 4}}),
        device="cpu")
    with pytest.raises(ValueError, match="capacities"):
        other.load_checkpoint(fn)
    # Device lists: one kind of device, and the spatial partition only on
    # a part layout (tests/test_multi_stream.py:245).
    with pytest.raises(ValueError, match="mixes CPU and CUDA"):
        tms.MultiStreamRunner(TCAM, S, mesh=["cpu", "cuda:0"], device="cpu")
    with pytest.raises(ValueError, match="device list"):
        tms.MultiStreamRunner(TCAM, S, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="part layout"):
        tms.MultiStreamRunner(TCAM, S, device="cpu", params=TParams.from_dict(
            {"engine": {"spatial_parts": 2}}))


def test_get_meshes_bit_exact_past_f32_ceiling(port_run):
    """Frame ids and the watermark above 2^24 (where an f32 cast stops
    round-tripping) still gate triangles exactly
    (tests/test_multi_stream.py:164)."""
    r, _ = port_run
    st = r.states
    tvb = st.tri_valid.numpy()
    assert tvb[0].any()
    big = 2 ** 24 + 5
    tri0 = int(np.flatnonzero(tvb[0])[0])
    slot = int(st.tris[0, tri0, 0])
    fid = torch.full_like(st.feat.frame_id, big)
    fid[0, slot] = big + 1            # would alias to big under an f32 cast
    r.states = st._replace(feat=st.feat._replace(frame_id=fid),
                           topo_frame_id=torch.full_like(st.topo_frame_id,
                                                         big))
    try:
        meshes = r.get_meshes()
    finally:
        r.states = st
    tris0 = st.tris[0].numpy()
    n_ghost = int((tvb[0] & (tris0 == slot).any(-1)).sum())
    assert n_ghost >= 1
    assert len(meshes[0][2]) == int(tvb[0].sum()) - n_ghost
    assert all(slot not in t for t in meshes[0][2])
    assert len(meshes[1][2]) == int(tvb[1].sum())


def test_deferred_rounds(seq, monkeypatch):
    """Deferred triangulation with every frame a poseframe: five rounds
    drained one by one, then the builds held back, two rounds in flight
    and the third dropped; the held rounds install in issue order, each
    with the watermark of its submit."""
    release = threading.Event()
    release.set()
    build = tms._HostTopologyBuilder.build

    def held(self, *a, **kw):
        release.wait(60)
        return build(self, *a, **kw)

    monkeypatch.setattr(tms._HostTopologyBuilder, "build", held)
    params = TParams.from_dict({**SMALL,
                                "input": {"poseframe_subsample_factor": 1}})
    r = tms.MultiStreamRunner(TCAM, S, params=params, device="cpu",
                              deferred_triangulation=True)
    try:
        for i in range(5):
            assert r.update(_frames(seq, i, _tse3))
            r.drain_topologies()
        assert r.states.topo_frame_id.tolist() == [4, 4]
        installed = r.states.tris.clone()
        release.clear()
        for i in range(5, N_FRAMES):
            assert r.update(_frames(seq, i, _tse3))
        assert len(r._pending_topo) == 2 and r.topo_dropped == 1
        assert torch.equal(r.states.tris, installed)   # none landed yet
        release.set()
        assert r._pending_topo[0].result()[:, -1].tolist() == [5, 5]
        r.drain_topologies()
        # The last install is the second held round's (frame 6's).
        assert r.states.topo_frame_id.tolist() == [6, 6]
        assert len(r.tri_round_s) == 7
        assert all(len(m[2]) for m in r.get_meshes())
    finally:
        release.set()
        r.shutdown()


def test_raster_vmap_rule_matches_plain_v4(port_run):
    """The raster operator under torch.func.vmap (CPU: the single-image
    code per image) against the per-image plain v4 version and the plain
    formulation, and the batched v4 setup against the single-image setup,
    on the runner's own meshes; no vmap fallback warning."""
    r, _ = port_run
    st = r.states
    pos, tris = st.vtx_uv, st.tris
    tv = st.tri_valid
    kw = dict(height=H, width=W)
    with _no_vmap_fallback():
        for use_kernel in (True, False):
            got = torch.func.vmap(
                lambda p, t, v: traster.raster_ids_op(
                    p, t, v, H, W, use_kernel, "v4"))(pos, tris, tv)
            for s in range(S):
                want = (raster_cuda.rasterize_tri_ids_v4_ref(
                    pos[s], tris[s], tv[s], **kw) if use_kernel else
                    traster.rasterize_tri_ids(pos[s], tris[s], tv[s], **kw))
                assert torch.equal(got[s], want), (use_kernel, s)
    assert torch.equal(raster_cuda.rasterize_tri_ids_v4_batched(
        pos, tris, tv, **kw), raster_cuda.rasterize_tri_ids_v4_batched_ref(
        pos, tris, tv, **kw))
    batched = raster_cuda.v4_setup_batched(pos, tris, tv, height=H,
                                           row_tile=2, long_thresh=48.0)
    for s in range(S):
        one = raster_cuda.v4_setup(pos[s], tris[s], tv[s], height=H,
                                   row_tile=2, long_thresh=48.0)
        for a, b in zip(batched, one):
            assert torch.equal(a[s], b)


@pytest.mark.cuda
def test_cuda_batched_kernel_matches_plain(port_run):
    """On the card: the batched v4 kernel equals its plain version (the
    per-image plain v4) bit for bit, in one launch; the chip smoke script
    repeats this at VGA on the runner's own inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r, _ = port_run
    st = r.states
    args = [t.cuda() for t in (st.vtx_uv, st.tris, st.tri_valid)]
    raster_cuda.reset_counters()
    out = raster_cuda.rasterize_tri_ids_v4_batched(*args, height=H, width=W)
    torch.cuda.synchronize()
    assert raster_cuda.rasterize_tri_ids_v4_batched.launches == 1
    assert raster_cuda.rasterize_tri_ids_v4_batched.images == S
    assert torch.equal(out, raster_cuda.rasterize_tri_ids_v4_batched_ref(
        *args, height=H, width=W))
