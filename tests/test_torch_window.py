"""The port's windowed and deferred-triangulation streaming path
(flame_ros_torch/models/engine.py: update_window, prefetch_window,
deferred triangulation; frontends/offline_runner.py:
run_offline_windowed) held against the JAX package's on the CPU, at
96x128 with 256 feature slots and 4 keyframes.

Windows and poseframe spacing are both 2 frames, so every JAX window has
one static signature (a poseframe, then a frame, with GT) and JAX builds
`_window_step` once; the JAX runs are shared by a module-scoped
fixture. The frames are rendered once, as numpy arrays, and the same
arrays go to both packages.

Tolerances are the lockstep test's (tests/test_torch_engine.py): integer
and boolean leaves exactly, float leaves to 1e-4 absolute plus 1e-5
relative, stats to 1e-4 (the photometric totals excepted, see
PHOTO_TOTALS); whole runs by a band, rmse within 15 % relative and
coverage within 0.05.
"""
import json
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flame_ros_tpu.config import FlameParams as JParams
from flame_ros_tpu.frontends.offline_runner import (
    run_offline_windowed as jrun_windowed)
from flame_ros_tpu.geometry.camera import Pinhole as JCam
from flame_ros_tpu.geometry.se3 import SE3 as JSE3
from flame_ros_tpu.models.engine import Flame as JFlame
from flame_ros_torch.config import FlameParams as TParams
from flame_ros_torch.datasets.synthetic import make_sequence
from flame_ros_torch.frontends.offline_runner import (Frame, main,
                                                      run_offline_windowed)
from flame_ros_torch.geometry.camera import Pinhole as TCam
from flame_ros_torch.geometry.se3 import SE3 as TSE3
from flame_ros_torch.models.engine import (DEVICE_STATS_KEYS, Flame,
                                           state_to_numpy)

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W = 96, 128
WIN = 2          # frames per window, and the poseframe spacing
JCAM = JCam(105.0, 105.0, 63.5, 47.5, W, H)
TCAM = TCam(105.0, 105.0, 63.5, 47.5, W, H)
SMALL = {"engine": {"max_features": 256, "max_keyframes": 4},
         "input": {"poseframe_subsample_factor": WIN}}
N_RUN = 12       # frames of the run_offline_windowed comparison
# The photometric totals sum the errors of bilinear samples of the
# keyframe at positions that differ between the packages by f32 noise
# (~1e-5 px) on image gradients of up to ~100 gray levels a pixel, scaled
# by the stride squared: they agree to a few percent, not to 1e-4.
PHOTO_TOTALS = ("total_photo_error", "avg_photo_error")


@pytest.fixture(scope="module")
def seq():
    s = make_sequence(14 * WIN + 2 * WIN, TCAM, motion="strafe",
                      device="cpu")
    return {"images": s.images.numpy(), "depths": s.depths.numpy(),
            "q": s.poses.q.numpy(), "t": s.poses.t.numpy(),
            "times": np.asarray(s.timestamps, np.float64)}


def _win(seq, w, pose_cls, wrap=None):
    """Frames of window w as update_window tuples; frame ids keep
    counting past the sequence (`wrap`) so the keyframe ring wraps."""
    out = []
    for i in range(WIN * w, WIN * w + WIN):
        j = i % wrap if wrap else i
        if pose_cls is JSE3:
            pose = JSE3(jnp.asarray(seq["q"][j]), jnp.asarray(seq["t"][j]))
        else:
            pose = TSE3(torch.from_numpy(seq["q"][j]),
                        torch.from_numpy(seq["t"][j]))
        out.append((float(seq["times"][j]), i, pose, seq["images"][j],
                    i % WIN == 0))
    return out


def _depths(seq, w):
    return seq["depths"][WIN * w:WIN * w + WIN]


def _frames(seq, n):
    return [Frame(i, float(seq["times"][i]), seq["images"][i],
                  seq["depths"][i], seq["q"][i], seq["t"][i])
            for i in range(n)]


def _jax_state(st):
    out = {f"feat.{k}": np.asarray(v) for k, v in st.feat._asdict().items()}
    out.update({k: np.asarray(v) for k, v in st._asdict().items()
                if k != "feat"})
    return out


def _close(a, b, what, atol=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-5, err_msg=what)


@pytest.fixture(scope="module")
def jax_runs(seq):
    """The JAX engine over windows 0-2 with synchronous triangulation:
    its state and host counters after window 1, and its products after
    window 2; and JAX run_offline_windowed over the first N_RUN frames."""
    je = JFlame(W, H, cam=JCAM, params=JParams.from_dict(SMALL))
    for w in range(2):
        assert je.update_window(_win(seq, w, JSE3), _depths(seq, w))
    carried = _jax_state(je.state)
    host = dict(num_poseframes=je._num_poseframes,
                frame_count=je._frame_count, kf_slot=je._kf_slot,
                max_frame_id=je._max_frame_id,
                installed_topo_wm=je._installed_topo_wm)
    assert je.update_window(_win(seq, 2, JSE3), _depths(seq, 2))
    after = {"state": _jax_state(je.state),
             "stats": je.flush_window_stats(),
             "status": np.asarray(je.last_status),
             "idepth": je.get_inverse_depth_map(),
             "filtered": je.get_filtered_inverse_depth_map(),
             "normals": je.get_normal_map(),
             "mesh": je.get_inverse_depth_mesh()}
    res = jrun_windowed(_frames(seq, N_RUN), JCAM, JParams.from_dict(SMALL),
                        window=WIN)
    return carried, host, after, res


def _engine(**kw):
    return Flame(W, H, cam=TCAM, params=TParams.from_dict(SMALL),
                 device="cpu", **kw)


def test_window_lockstep_and_getters(seq, jax_runs):
    """A JAX state carried into the port; one window through both
    update_window: every state leaf, the window's stats rows, the status
    codes and the three mesh getters (plus the dense map) agree."""
    carried, host, after, _ = jax_runs
    te = _engine()
    te.load_state(carried, host=host)
    assert te.update_window(_win(seq, 2, TSE3), _depths(seq, 2))
    tst = state_to_numpy(te.state)
    assert sorted(tst) == sorted(after["state"])
    for k, v in after["state"].items():
        _close(tst[k], v, k)
    rows = te.flush_window_stats()
    assert len(rows) == len(after["stats"]) == WIN
    for b, (tr, jr) in enumerate(zip(rows, after["stats"])):
        for k in DEVICE_STATS_KEYS:
            tol = dict(rel=1e-4, abs=1e-4)
            if k in PHOTO_TOTALS:
                tol = dict(rel=0.05, abs=0.01)
            assert tr[k] == pytest.approx(jr[k], **tol), (b, k)
        assert tr["health"] == 1.0
    np.testing.assert_array_equal(te.last_status, after["status"])
    assert te._topo_installs == 1     # the window's poseframe, synchronous
    _close(te.get_inverse_depth_map(), after["idepth"], "idepth")
    _close(te.get_filtered_inverse_depth_map(), after["filtered"],
           "filtered idepth")
    assert np.isfinite(after["filtered"]).mean() > 0.2
    _close(te.get_normal_map(), after["normals"], "normal map")
    names = ("vertices", "idepths", "normals", "triangles", "validity",
             "edges")
    for name, t, j in zip(names, te.get_inverse_depth_mesh(),
                          after["mesh"]):
        _close(t, j, f"mesh {name}")
    assert len(after["mesh"][3]) > 50


def test_run_offline_windowed_band(seq, jax_runs):
    jres = jax_runs[3]
    tres = run_offline_windowed(_frames(seq, N_RUN), TCAM,
                                TParams.from_dict(SMALL), window=WIN,
                                device="cpu")
    assert tres.frames_processed == jres.frames_processed == N_RUN
    assert tres.frames_failed == 0
    assert np.isfinite(tres.mean_rmse)
    assert tres.mean_rmse == pytest.approx(jres.mean_rmse, rel=0.15)
    assert abs(tres.final_coverage - jres.final_coverage) <= 0.05
    assert tres.final_coverage > 0.3


def test_prefetch_matches_plain_and_keeps_order(seq):
    """prefetch_window + update_window(prefetched=...) is bit-identical to
    plain update_window; handles are consumed in issue order only, and
    nothing else may update while one is outstanding."""
    a, b = _engine(), _engine()
    for w in range(3):
        assert a.update_window(_win(seq, w, TSE3), _depths(seq, w))
    pre = b.prefetch_window(_win(seq, 0, TSE3), _depths(seq, 0))
    for w in range(3):
        nxt = (b.prefetch_window(_win(seq, w + 1, TSE3), _depths(seq, w + 1))
               if w + 1 < 3 else None)
        assert b.update_window(prefetched=pre)
        pre = nxt
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    for k in sa:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
    np.testing.assert_array_equal(b._dev_stats_window.numpy(),
                                  a._dev_stats_window.numpy())
    h1 = b.prefetch_window(_win(seq, 3, TSE3))
    h2 = b.prefetch_window(_win(seq, 4, TSE3))
    with pytest.raises(RuntimeError):
        b.update_window(prefetched=h2)
    with pytest.raises(RuntimeError):
        b.update_window(_win(seq, 5, TSE3))
    f = _win(seq, 5, TSE3)[0]
    with pytest.raises(RuntimeError):
        b.update(*f)
    assert b.update_window(prefetched=h1)
    assert b.update_window(prefetched=h2)


def test_deferred_pipeline(seq):
    """Deferred triangulation: at most 2 builds in flight; with the worker
    stalled, the drop policy skips poseframes; finished builds install in
    issue order, only the newest of them, with a watermark that never
    goes backwards; the map stays accurate."""
    eng = _engine(deferred_triangulation=True)
    installed = []
    orig_install = eng._install_topology

    def spy(buf, **kw):
        installed.append(kw.get("wm"))
        return orig_install(buf, **kw)
    eng._install_topology = spy
    gate = threading.Event()
    orig_build = eng._build_topology_host

    def stalled(uv, el, wm):
        gate.wait(timeout=60.0)
        return orig_build(uv, el, wm)
    eng._build_topology_host = stalled
    try:
        for w in range(4):
            assert eng.update_window(_win(seq, w, TSE3), _depths(seq, w))
            assert len(eng._pending_tri) <= 2
    finally:
        gate.set()
    assert eng._tri_dropped == 2 and not installed
    assert eng._stale_tri_windows >= 2
    wms = [f.wm for f in eng._pending_tri]
    eng._apply_pending_triangulation(block=True)
    assert not eng._pending_tri
    # Both finished builds drain at once: only the newer installs.
    assert installed == [max(wms)] and eng._tri_superseded == 1
    assert int(eng.state.topo_frame_id) == max(wms)
    eng._build_topology_host = orig_build
    wm_seen = [int(eng.state.topo_frame_id)]
    for w in range(4, 10):
        assert eng.update_window(_win(seq, w, TSE3), _depths(seq, w))
        assert len(eng._pending_tri) <= 2
        # Let the worker finish, so the next dispatch installs it.
        for f in list(eng._pending_tri):
            f.result()
        wm_seen.append(int(eng.state.topo_frame_id))
    eng._apply_pending_triangulation(block=True)
    wm_seen.append(int(eng.state.topo_frame_id))
    assert wm_seen == sorted(wm_seen) and wm_seen[-1] > wm_seen[0]
    assert installed == sorted(installed)           # issue order
    # An older build than the installed one is skipped, not installed.
    n, sup = eng._topo_installs, eng._tri_superseded
    st = eng.state
    old = eng._build_topology_host(st.vtx_uv.numpy(),
                                   st.vtx_in_graph.numpy(), wm_seen[0])
    eng._install_topology(old, wm=wm_seen[0] - 1)
    assert eng._topo_installs == n and eng._tri_superseded == sup + 1
    assert int(eng.state.topo_frame_id) == wm_seen[-1]
    eng.shutdown()
    last = WIN * 10 - 1
    est = eng.get_inverse_depth_map()
    d = seq["depths"][last]
    gt = np.where(d > 0, 1.0 / np.maximum(d, 1e-6), 0.0)
    m = np.isfinite(est) & (gt > 0)
    assert m.mean() > 0.3
    assert np.median(np.abs(est - gt)[m]) < 0.03


def test_main_window_cpu(tmp_path, capsys):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("engine:\n  max_features: 256\n  max_keyframes: 4\n")
    main(["--dataset", "synthetic", "--frames", "5", "--device", "cpu",
          "--config", str(cfg), "--window", "3", "--save-products",
          "--out", str(tmp_path / "out")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 5 and summary["failed"] == 0
    assert set(summary) == {"frames", "failed", "fps", "idepth_rmse",
                            "precision", "recall", "coverage", "abs_rel",
                            "delta1"}
    out = tmp_path / "out"
    assert (out / "stats.txt").exists()
    with np.load(out / "final_mesh.npz") as mesh:
        assert mesh["triangles"].shape[1] == 3
        assert len(mesh["tri_validity"]) == len(mesh["triangles"])
    assert np.load(out / "final_idepth.npy").shape == (240, 320)  # QVGA


def test_update_defers_triangulation(seq):
    """update() goes through the window dispatch, so deferred mode defers
    the per-frame poseframe's triangulation too: it installs at a later
    dispatch, not at once."""
    eng = _engine(deferred_triangulation=True, tri_backpressure="block")
    for i in range(2 * WIN):
        t, fid, pose, img, pf = _win(seq, i // WIN, TSE3)[i % WIN]
        n = eng._topo_installs
        assert eng.update(t, fid, pose, img, pf,
                          gt_depth=seq["depths"][i])
        if pf:
            # Scheduled, not installed: the build is on the worker.
            assert eng._topo_installs == n and len(eng._pending_tri) == 1
            eng._pending_tri[0].result()
        elif i % WIN == 1:
            # The finished build installed at this frame's dispatch.
            assert eng._topo_installs == n + 1 and not eng._pending_tri
    assert eng.flush_stats()["health"] == 1.0
    eng.shutdown()


def test_streaming_coverage_survives_ring_wraps(seq):
    """Port of tests/test_engine.py::test_streaming_coverage_survives_
    ring_wraps: the prefetched, deferred streaming loop (prefetch depth
    2) keeps dense coverage stable through several keyframe-ring wraps
    (14 poseframes over 4 keyframes)."""
    eng = _engine(deferred_triangulation=True)
    n_win = 14

    def win(w):
        return _win(seq, w, TSE3, wrap=len(seq["images"]))

    covs = []
    pre = eng.prefetch_window(win(0))
    nxt = eng.prefetch_window(win(1))
    for w in range(n_win):
        assert eng.update_window(prefetched=pre)
        pre, nxt = nxt, (eng.prefetch_window(win(w + 2))
                         if w + 2 < n_win else None)
        covs.append(float(np.isfinite(eng.get_inverse_depth_map()).mean()))
    eng._apply_pending_triangulation(block=True)
    eng.shutdown()
    assert eng.num_poseframes == n_win
    steady = np.asarray(covs[4:])      # skip the map build-up
    assert steady.max() > 0.4, f"map never built: {covs}"
    assert steady.min() > 0.5 * steady.max(), f"coverage collapse: {covs}"
    assert steady[-1] > 0.3, f"final coverage {steady[-1]}: {covs}"
