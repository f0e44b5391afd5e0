"""The port's feature-axis layout (flame_ros_torch/parallel/feat_shard.py,
`make_mesh(stream_axis=)`) on the CPU.

- The batched frame step on 4 CPU devices with stream_axis=2 (two stream
  groups, each stream's lanes over 2 devices) against the JAX package's
  step on the same ("stream", "feat") mesh and the same tiny setup
  (tests/test_parallel.py:21-48): coverage within 1e-5, the dense
  idepth maps within 1e-4 where both are finite, finiteness equal on at
  least 99.9 % of the pixels (tests/test_parallel.py's bounds). The port's
  feat step also equals its plain step exactly.
- `MultiStreamRunner` on a feat mesh (F = 2 and 4 lane blocks) against
  the plain runner over 8 frames of a 96x128 sequence (256 feature slots,
  a poseframe every 6 frames, GT depth, stream 1 one frame behind): every
  state leaf equal bit for bit after every frame, the stats within 1e-6
  relative (the smoothing cost sums are split over the blocks); the same
  with the matmul adjoint and bf16 gathers; a feat checkpoint loads into
  the plain runner and a plain one into a feat runner.
- `make_mesh(stream_axis=)`'s shapes (tests/test_multi_stream.py:271-286
  for the rule that picks stream groups).
"""

import numpy as np
import pytest
import torch

from flame_ros_torch.config import FlameParams
from flame_ros_torch.datasets.synthetic import make_sequence
from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.geometry.se3 import SE3
from flame_ros_torch.models.engine import state_leaves
from flame_ros_torch.parallel import dist_smoke
from flame_ros_torch.parallel import multi_stream as tms
from flame_ros_torch.parallel.multi_stream import (Mesh, MultiStreamRunner,
                                                   make_mesh)

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W = 96, 128
TCAM = Pinhole(105.0, 105.0, 63.5, 47.5, W, H)
SMALL = {"engine": {"max_features": 256, "max_keyframes": 4},
         "input": {"poseframe_subsample_factor": 6}}
CPU = torch.device("cpu")


def test_feat_frame_step_matches_jax():
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as g
    from flame_ros_tpu.parallel import multi_stream as jms

    params, cam, state, pyr, q, t = g._tiny_setup()
    mesh = jms.make_mesh(jax.devices()[:4], stream_axis=2)
    batched = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (2,) + x.shape), state)
    batched = jax.tree.map(jax.device_put, batched,
                           jms.state_shardings(mesh))
    with mesh:
        _, j_idepth, j_cov = jms.batched_frame_step(
            batched, jnp.broadcast_to(pyr[None], (2,) + pyr.shape),
            jnp.broadcast_to(q[None], (2, 4)),
            jnp.broadcast_to(t[None], (2, 3)), jnp.ones((2,), jnp.int32),
            cam=cam, params=params)

    tp, tcam, states, pyrs, qs, ts, fids = dist_smoke._batch("cpu")
    tmesh = make_mesh(["cpu"] * 4, stream_axis=2)
    assert tmesh.shape == {"stream": 2, "feat": 2}
    st, idepth, cov = tms.batched_frame_step(
        states, pyrs, qs, ts, fids, cam=tcam, params=tp, mesh=tmesh)
    np.testing.assert_allclose(cov.numpy(), np.asarray(j_cov), atol=1e-5)
    a, b = np.asarray(j_idepth), idepth.numpy()
    both = np.isfinite(a) & np.isfinite(b)
    assert (np.isfinite(a) == np.isfinite(b)).mean() > 0.999
    np.testing.assert_allclose(b[both], a[both], atol=1e-4)
    # The feat step is the plain step, bit for bit.
    pst, pidepth, pcov = tms.batched_frame_step(
        states, pyrs, qs, ts, fids, cam=tcam, params=tp)
    assert torch.equal(cov, pcov)
    assert np.array_equal(idepth.numpy(), pidepth.numpy(), equal_nan=True)
    for x, y in zip(state_leaves(st), state_leaves(pst)):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def seq():
    s = make_sequence(9, TCAM, motion="strafe", device="cpu")
    return (torch.clamp(s.images, 0, 255).to(torch.uint8).numpy(),
            s.poses.q, s.poses.t, s.depths.numpy(), s.timestamps)


def _frames(seq, i):
    imgs, q, t, depths, stamps = seq
    ids = [i, max(i - 1, 0)]
    return ([(float(stamps[k]), k, SE3(q[k], t[k]), imgs[k]) for k in ids],
            depths[ids])


def _drive(seq, runners, n):
    """n frames through every runner; each runner's stats rows per
    frame. The leaves of runners[1:] must equal runners[0]'s after every
    frame."""
    rows = [[] for _ in runners]
    for i in range(n):
        f, gt = _frames(seq, i)
        for k, r in enumerate(runners):
            assert r.update(f, gt_depths=gt)
            rows[k].append(r.flush_stats())
        ref = state_leaves(runners[0].states)
        for r in runners[1:]:
            for j, (a, b) in enumerate(zip(state_leaves(r.states), ref)):
                assert torch.equal(a, b), (i, j)
    return rows


def _stats_rel(rows_a, rows_b):
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1.0)
               for ra, rb in zip(rows_a, rows_b)
               for a, b in zip(ra, rb) for k in a)


@pytest.fixture(scope="module")
def runs(seq):
    params = FlameParams.from_dict(SMALL)
    plain = MultiStreamRunner(TCAM, 2, params=params, device="cpu")
    feats = [MultiStreamRunner(TCAM, 2, params=params,
                               mesh=make_mesh(["cpu"] * F, stream_axis=1))
             for F in (2, 4)]
    rows = _drive(seq, [plain] + feats, 8)
    return params, plain, feats, rows


def test_feat_runner_equals_plain_runner(runs, seq):
    params, plain, feats, rows = runs
    assert [len(r.groups[0]) for r in feats] == [2, 4]
    assert all(r.feat and not r.spatial for r in feats)
    for r, rr in zip(feats, rows[1:]):
        assert _stats_rel(rr, rows[0]) <= 1e-6
        assert np.array_equal(r.get_idepth_maps(), plain.get_idepth_maps(),
                              equal_nan=True)
        for (u1, x1, t1), (u2, x2, t2) in zip(r.get_meshes(),
                                              plain.get_meshes()):
            assert (np.array_equal(u1, u2) and np.array_equal(x1, x2)
                    and np.array_equal(t1, t2))
        assert r.group_launches == [0] and r.local_streams() == [0, 1]
    # The matmul adjoint and bf16 gathers under the feat layout: the
    # same bit-for-bit equality with their plain runner.
    opt = FlameParams.from_dict({
        "engine": dict(SMALL["engine"], nltgv2_adjoint="matmul",
                       compute_dtype="bfloat16"),
        "input": SMALL["input"]})
    p2 = MultiStreamRunner(TCAM, 2, params=opt, device="cpu")
    f2 = MultiStreamRunner(TCAM, 2, params=opt,
                           mesh=make_mesh(["cpu"] * 2, stream_axis=1))
    rows2 = _drive(seq, [p2, f2], 7)
    assert _stats_rel(rows2[1], rows2[0]) <= 1e-6


def test_feat_checkpoint_round_trip(runs, seq, tmp_path):
    """A feat runner's checkpoint (the JAX layout) loads into the plain
    runner, and the plain runner's into a feat runner; the next frame
    keeps all three equal."""
    params, plain, feats, _ = runs
    fn = feats[1].save_checkpoint(str(tmp_path / "feat"))
    back_plain = MultiStreamRunner(TCAM, 2, params=params, device="cpu")
    back_plain.load_checkpoint(fn)
    fn2 = plain.save_checkpoint(str(tmp_path / "plain"))
    back_feat = MultiStreamRunner(TCAM, 2, params=params,
                                  mesh=make_mesh(["cpu"] * 2,
                                                 stream_axis=1))
    back_feat.load_checkpoint(fn2)
    ref = state_leaves(plain.states)
    for r in (back_plain, back_feat):
        for a, b in zip(state_leaves(r.states), ref):
            assert torch.equal(a, b)
    _drive(seq, [plain, back_plain, back_feat], 1)


def test_make_mesh_stream_axis():
    devs = ["cpu"] * 8
    m = make_mesh(devs, stream_axis=2)
    assert isinstance(m, Mesh) and m.axis_names == ("stream", "feat")
    assert m.shape == {"stream": 2, "feat": 4}
    assert m.devices == [[CPU] * 4] * 2
    assert make_mesh(devs, stream_axis=8).shape == {"stream": 8, "feat": 1}
    assert make_mesh(devs, stream_axis=1).shape == {"stream": 1, "feat": 8}
    with pytest.raises(ValueError):
        make_mesh(devs, stream_axis=3)
    # The rule behind mesh="auto" keeps choosing pure stream groups
    # (tests/test_multi_stream.py:271-286): gcd(S, n) devices.
    assert make_mesh(devs, auto_for_streams=1) == [CPU]
    assert make_mesh(devs, auto_for_streams=4) == [CPU] * 4
    assert make_mesh(devs, auto_for_streams=3) == [CPU]
    assert make_mesh(devs, auto_for_streams=8) == [CPU] * 8
    params = FlameParams.from_dict(SMALL)
    # A feat axis of 1 is stream groups; lanes must split evenly.
    one = MultiStreamRunner(TCAM, 2, params=params,
                            mesh=make_mesh(["cpu"] * 2, stream_axis=2))
    assert not one.feat and one.groups == [[CPU], [CPU]]
    with pytest.raises(ValueError, match="divide"):
        MultiStreamRunner(TCAM, 2, params=params,
                          mesh=Mesh([["cpu"] * 3]))
