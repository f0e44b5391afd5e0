"""The pod-dense configuration (cfg/pod_dense_ba.yaml) of the port's
tracking node held against the JAX package's on the CPU, at a small
width: 96x128, 13 frames of a 30-frame strafe rendered by the port's
renderer, tracking with windowed BA on every poseframe, and the
configuration's knobs at 1024 feature slots (2048 triangles) and a BA
budget of 1024 points: detection win 4 with min_grad 8, 30 primal-dual
sweeps, the gather adjoint and the "most_owned" BA anchor (4 keyframes,
a poseframe every 3rd frame, so that BA runs within 13 frames).

- The YAML's knobs are all the test changes: every field it sets, set
  on the small configuration, is the field the YAML gives (the width
  fields excepted).
- The stream: the same frames enter the trajectory and become
  poseframes, BA runs as often in both (at least twice), each solve at
  the full 1024 points, and the failure and relocalization counts are
  equal (zero). This closed loop parts on rounding: the JAX run on the
  frames with a random half of their pixels one float32 step up
  (scripts/jax_tracking_reference.py's --perturb 1) leaves the JAX run
  by more than 1e-4 from frame 5 on, where the convergence-gated sweeps
  of the dense graph differ. Before that frame the port is held to the
  JAX run with tests/test_torch_tracking_node.py's bounds (poses 1e-3,
  track costs 1e-3 relative); from it on every pose, the keyframe ring,
  every track cost and every BA cost may lie no further from the JAX run
  than the moved JAX run does, plus the same bounds.
- The last poseframe's BA inputs: `gather_ba_inputs` with the
  "most_owned" anchor on the JAX node's state carried across
  (`state_from_numpy`) equal bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from flame_ros_tpu.config import FlameParams as JParams
from flame_ros_tpu.frontends.nodelet import FlameNodelet as JNode
from flame_ros_tpu.geometry.camera import Pinhole as JCam
from flame_ros_tpu.models import ba as jba
from flame_ros_torch.config import FlameParams as TParams
from flame_ros_torch.datasets.synthetic import make_trajectory, render_frame
from flame_ros_torch.frontends import nodelet as tnodelet
from flame_ros_torch.frontends.nodelet import FlameNodelet as TNode
from flame_ros_torch.geometry.camera import Pinhole as TCam
from flame_ros_torch.models import ba as tba
from flame_ros_torch.models.engine import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

H, W = 96, 128
JCAM = JCam(105.0, 105.0, 63.5, 47.5, W, H)
TCAM = TCam(105.0, 105.0, 63.5, 47.5, W, H)
POD_DENSE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cfg", "pod_dense_ba.yaml")
# cfg/pod_dense_ba.yaml at 1024 feature slots and 1024 BA points.
SMALL_POD = {"engine": {"max_features": 1024, "max_keyframes": 4,
                        "nltgv2_adjoint": "gather",
                        "pd_iters_per_frame": 30},
             "features": {"detection": {"win_size": 4,
                                        "min_grad_mag": 8.0}},
             "input": {"poseframe_subsample_factor": 3},
             "pose_tracking": {"ba_budget": 1024,
                               "ba_anchor": "most_owned"}}
# The fields SMALL_POD sets to fit the width, not taken from the YAML.
WIDTH = {("engine", "max_features"), ("engine", "max_keyframes"),
         ("input", "poseframe_subsample_factor"),
         ("pose_tracking", "ba_budget")}
N = 13


def _fields(d, path=()):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _fields(v, path + (k,))
        else:
            yield path + (k,), v


def _get(params, path):
    for k in path:
        params = getattr(params, k)
    return params


def _perturbed(imgs, seed):
    """imgs with a random half of its pixels one float32 step up (as
    scripts/jax_tracking_reference.py --perturb)."""
    up = np.random.default_rng(seed).random(imgs.shape) < 0.5
    return np.where(up, np.nextafter(imgs, np.float32(np.inf)), imgs)


def _run(node, imgs, depth0, spy=None):
    points = []
    if spy is not None:
        hb = spy.hybrid_bundle_adjust

        def keep(*a, **kw):
            points.append(int(a[5].shape[0]))
            return hb(*a, **kw)

        spy.hybrid_bundle_adjust = keep
    try:
        for i in range(N):
            assert node.push_frame(i, i / 30.0, gray=imgs[i],
                                   depth=depth0 if i == 0 else None)
            node.run_until_idle(idle_timeout=0.01)
    finally:
        if spy is not None:
            spy.hybrid_bundle_adjust = hb
    return node, points


@pytest.fixture(scope="module")
def streams():
    """The port's node, the JAX node on the same frames and the JAX node
    on the frames moved by one float32 step (seed 1)."""
    poses = make_trajectory(30, "strafe", device="cpu")
    frames = [render_frame(TCAM, poses.q[i], poses.t[i]) for i in range(N)]
    imgs = np.stack([g.numpy() for g, _ in frames])
    depth0 = frames[0][1].numpy()

    def jnode():
        return JNode(JCAM, JParams.from_dict(SMALL_POD),
                     pose_source="tracking", ba_refine=True,
                     eval_gt_depth=True)

    return {"jax": _run(jnode(), imgs, depth0)[0],
            "jax_moved": _run(jnode(), _perturbed(imgs, 1), depth0)[0],
            "torch": _run(TNode(TCAM, TParams.from_dict(SMALL_POD),
                                pose_source="tracking", ba_refine=True,
                                eval_gt_depth=True, device="cpu"),
                          imgs, depth0, spy=tnodelet)}


def _pose(node):
    return np.stack([np.concatenate([np.asarray(p.q).ravel(),
                                     np.asarray(p.t).ravel()])
                     for _, _, p in node.trajectory])


def _beyond(port, jax, moved, tol, rel=False):
    """How far the port's largest distance from the JAX run exceeds the
    moved JAX run's largest distance from it plus tol (each relative to
    the JAX run's values if rel); 0 where it does not."""
    port, jax, moved = (np.asarray(x, np.float64) for x in (port, jax,
                                                             moved))
    scale = np.abs(jax) if rel else 1.0
    mine = (np.abs(port - jax) / scale).max()
    theirs = (np.abs(moved - jax) / scale).max()
    return float(max(mine - theirs - tol, 0.0))


def test_small_pod_dense_is_the_yaml():
    yaml = TParams.from_yaml(POD_DENSE)
    small = TParams.from_dict(SMALL_POD)
    assert yaml == TParams.from_yaml(POD_DENSE)
    for path, _ in _fields(dataclasses.asdict(JParams.from_yaml(POD_DENSE))):
        if path not in WIDTH and _get(yaml, path) != _get(TParams(), path):
            assert _get(small, path) == _get(yaml, path), path
    assert small.engine.max_triangles == 2048


def test_pod_dense_stream_matches_jax(streams):
    jn, jm, (tn, points) = streams["jax"], streams["jax_moved"], \
        streams["torch"]
    ids = [i for i, _, _ in tn.trajectory]
    assert ids == [i for i, _, _ in jn.trajectory] == \
        [i for i, _, _ in jm.trajectory] == list(range(N))
    assert [i for i, _ in tn._pg_nodes] == [i for i, _ in jn._pg_nodes]
    assert tn.engine.num_poseframes == jn.engine.num_poseframes
    assert len(tn.ba_costs) == len(jn.ba_costs) == len(jm.ba_costs) >= 2
    assert points == [1024] * len(tn.ba_costs)
    assert (tn.n_track_failed_frames, tn.n_relocalizations) == \
        (jn.n_track_failed_frames, jn.n_relocalizations) == (0, 0)
    assert tn.engine.num_failed_frames == jn.engine.num_failed_frames == 0
    # The closed loop parts where the JAX run on frames one float32 step
    # apart parts from the JAX run (the convergence-gated 30 sweeps): up
    # to that frame, the node test's bounds against the JAX run.
    tp, jp, mp = _pose(tn), _pose(jn), _pose(jm)
    part = int(np.argmax(np.abs(mp - jp).max(1) > 1e-4))
    assert part >= 5, part
    np.testing.assert_allclose(tp[:part], jp[:part], atol=1e-3)
    np.testing.assert_allclose(tn.track_costs[:part - 1],
                               jn.track_costs[:part - 1], rtol=1e-3)
    # From it on, every pose, the keyframe ring, every track cost and
    # every BA cost no further from the JAX run than the moved JAX run is,
    # plus those bounds.
    tst = state_to_numpy(tn.engine.state)
    np.testing.assert_array_equal(tst["kf_ids"],
                                  np.asarray(jn.engine.state.kf_ids))
    far = {"poses": _beyond(tp[part:], jp[part:], mp[part:], 1e-3),
           "track_costs": _beyond(tn.track_costs[part - 1:],
                                  jn.track_costs[part - 1:],
                                  jm.track_costs[part - 1:], 1e-3, rel=True),
           "ba_costs": _beyond(tn.ba_costs, jn.ba_costs, jm.ba_costs, 1e-3,
                               rel=True)}
    for k in ("kf_q", "kf_t"):
        far[k] = _beyond(tst[k], np.asarray(getattr(jn.engine.state, k)),
                         np.asarray(getattr(jm.engine.state, k)), 1e-3)
    assert not any(far.values()), far


def test_pod_dense_ba_gather_matches_jax(streams):
    st = streams["jax"].engine.state
    d = {f"feat.{k}": np.asarray(v) for k, v in st.feat._asdict().items()}
    d.update({k: np.asarray(v) for k, v in st._asdict().items()
              if k != "feat"})
    ts = state_from_numpy(d, "cpu")
    P = 1024
    jbuf = np.asarray(jba.gather_ba_inputs(
        st.kf_valid, st.kf_ids, st.feat.valid, st.feat.kf_idx,
        st.feat.uv_ref, st.feat.mu, budget=P, anchor="most_owned"))
    tpk = tba.gather_ba_inputs(ts.kf_valid, ts.kf_ids, ts.feat.valid,
                               ts.feat.kf_idx, ts.feat.uv_ref, ts.feat.mu,
                               budget=P, anchor="most_owned")
    np.testing.assert_array_equal(tpk.numpy(), jbuf)
    K = int(ts.kf_valid.shape[0])
    assert int(jbuf[2 * K + 1]) >= 24 and (jbuf[:K] > 0.5).sum() >= 3
