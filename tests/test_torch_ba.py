"""The port's windowed bundle adjustment (`flame_ros_torch/models/ba.py`)
held against the JAX package's on the CPU, at 96x128 with 3-level
pyramids of frames 0, 2, 4, 6 of a 30-frame strafe rendered by the port's
renderer: K = 4 keyframes, P = 64 points (60 textured pixels of frame 0
at their rendered depth, and 4 on the image border), frames 1-3 moved
off their poses by a fixed seeded twist. The same numpy inputs go
through both packages.

- The Jacobians of the residual channels (intensity, gradient
  magnitude, reprojection; affine exposure columns) at the first
  iteration, at both levels of the live schedule, against `jax.jacfwd`
  per (point, frame) pair built from the JAX package's own `_warp_uv`,
  `_grad_mag` and sampler: residuals and each Jacobian column to 1e-4
  of the channel's or column's largest magnitude (at least 1), border
  points included.
- `bundle_adjust_window` at the live schedule (4 fine / 2 coarse
  iterations, level 1) with affine, gradient and reprojection channels,
  and photometric-only (no affine, no gradient, no matches): q, t and
  idepths to 1e-4, final_cost to 1e-4 relative, n_valid exactly.
- `gather_ba_inputs`, both anchors, on a feature pool with keyframe
  indices outside [0, K) (negative ones wrap, as numpy indexing does):
  bit for bit.
- `match_window_points`: the match validity (status == OK) bit for bit,
  the matches to 1e-3 px; `refine_matches_2d` on those: 1e-3 px,
  validity exactly.
- `discrete_pose_presearch` from poses 0.05 off: q and t to 1e-5 (the
  same argmin moves), and `hybrid_bundle_adjust(rounds=3,
  pre_search=True)`: as `bundle_adjust_window`.
- The point-sharded solver: `hybrid_bundle_adjust_sharded` over two CPU
  devices against the unsharded one-round hybrid (1e-5) and against the
  JAX package's on a two-device mesh, and the nodelet's BA routed
  through it by `pose_tracking.ba_sharded=True`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flame_ros_tpu.geometry.camera import Pinhole as JCam
from flame_ros_tpu.geometry.se3 import SE3 as JSE3
from flame_ros_tpu.models import ba as jba
from flame_ros_tpu.ops.pyramid import bilinear_pyramid as j_sample
from flame_ros_torch.datasets.synthetic import make_trajectory, render_frame
from flame_ros_torch.geometry.camera import Pinhole as TCam
from flame_ros_torch.models import ba as tba
from flame_ros_torch.ops.pyramid import build_pyramid

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W = 96, 128
JCAM = JCam(105.0, 105.0, 63.5, 47.5, W, H)
TCAM = TCam(105.0, 105.0, 63.5, 47.5, W, H)
KF = (0, 2, 4, 6)
K, P = len(KF), 64
# The nodelet's live schedule.
LIVE = dict(num_iters=4, coarse_iters=2, level=1)


@pytest.fixture(scope="module")
def win():
    """Numpy inputs of one BA window, and its GT poses."""
    poses = make_trajectory(30, "strafe", device="cpu")
    frames = [render_frame(TCAM, poses.q[i], poses.t[i]) for i in KF]
    imgs = [g.numpy() for g, _ in frames]
    pyrs = np.stack([build_pyramid(torch.from_numpy(g), 3).numpy()
                     for g in imgs])
    depth0 = frames[0][1].numpy()
    gy, gx = np.gradient(imgs[0])
    score = np.hypot(gx, gy)
    score[:4], score[-4:], score[:, :4], score[:, -4:] = 0, 0, 0, 0
    idx = np.argsort(-score.ravel(), kind="stable")[::7][:P - 4]
    uv = np.stack([idx % W, idx // W], -1).astype(np.float32)
    border = np.array([[0, 40], [W - 1, 20], [70, 0], [30, H - 1]],
                      np.float32)
    uv = np.concatenate([uv, border])
    d0 = (1.0 / depth0[uv[:, 1].astype(int), uv[:, 0].astype(int)]
          ).astype(np.float32)
    pv = np.ones(P, bool)
    pv[5] = False
    q = poses.q.numpy()[list(KF)]
    t = poses.t.numpy()[list(KF)]
    rng = np.random.default_rng(3)
    qn, tn = q.copy(), t.copy()
    for k in range(1, K):
        T = (JSE3(jnp.asarray(q[k]), jnp.asarray(t[k]))
             @ JSE3.exp(jnp.asarray(rng.normal(0, 0.01, 6), jnp.float32)))
        qn[k], tn[k] = np.asarray(T.q), np.asarray(T.t)
    # Observed matches: the GT projections, 0.7 px of noise, one in five
    # marked invalid.
    uv_gt = np.asarray(tba._warp_uv(
        torch.zeros(K, 1, 6), torch.from_numpy(d0), torch.from_numpy(uv),
        torch.from_numpy(q)[:, None], torch.from_numpy(t)[:, None],
        torch.from_numpy(q[0]), torch.from_numpy(t[0]), TCAM)[0])
    uv_obs = (uv_gt.transpose(1, 0, 2)
              + rng.normal(0, 0.7, (P, K, 2))).astype(np.float32)
    obs_ok = rng.random((P, K)) > 0.2
    return dict(pyrs=pyrs, q=qn, t=tn, q_gt=q, t_gt=t, uv=uv, d0=d0,
                pv=pv, uv_obs=uv_obs, obs_ok=obs_ok,
                kv=np.ones(K, bool))


def _j(w, *keys):
    return [jnp.asarray(w[k]) for k in keys]


def _t(w, *keys):
    return [torch.from_numpy(np.ascontiguousarray(w[k])) for k in keys]


ARGS = ("pyrs", "q", "t", "kv", "uv", "d0", "pv")


@jax.jit
def _jax_jacobians(pyrs, q, t, uv, d0, uv_obs, obs_ok, lv):
    """Residual channels, weights and per-pair jax.jacfwd Jacobians at
    the window's first iteration (g = 1, o = 0), at level lv, written
    like bundle_adjust_window's `_res_channels` from the JAX package's
    own pieces. [P, K] layout."""
    lvp = jnp.full((P,), lv)
    iref = j_sample(pyrs[0], uv, lvp)[0]
    step = jnp.exp2(lv.astype(jnp.float32))
    du, dv = jnp.array([1.0, 0.0]) * step, jnp.array([0.0, 1.0]) * step

    def smp(u):
        return j_sample(pyrs[0], u, lvp)[0]

    gx = (smp(uv + du) - smp(uv - du)) / (2.0 * step)
    gy = (smp(uv + dv) - smp(uv - dv)) / (2.0 * step)
    gref = jnp.sqrt(gx * gx + gy * gy + 1e-6)

    def res(tau, d_p, p, j):
        uv_j, front = jba._warp_uv(tau[:6], d_p, uv[p], q[j], t[j], q[0],
                                   t[0], JCAM)
        val, ok = j_sample(pyrs[j], uv_j[None, :], lv)
        wt = (front & ok[0]).astype(jnp.float32)
        g_eff, o_eff = 1.0 + tau[6], 0.0 + tau[7]
        gm, gok = jba._grad_mag(pyrs[j], uv_j, lv)
        wo = wt * obs_ok[p, j].astype(jnp.float32)
        d = uv_j - uv_obs[p, j]
        return jnp.stack([(val[0] - (g_eff * iref[p] + o_eff)) * wt,
                          0.5 * (gm - g_eff * gref[p]) * wt
                          * gok.astype(jnp.float32),
                          4.0 * d[0] * wo, 4.0 * d[1] * wo]), wt

    def pair(d_p, p, j):
        f = lambda tau, dd: res(tau, dd, p, j)[0]   # noqa: E731
        tau0 = jnp.zeros(8)
        r, wt = res(tau0, d_p, p, j)
        return (r, wt, jax.jacfwd(f, argnums=0)(tau0, d_p),
                jax.jacfwd(f, argnums=1)(tau0, d_p))

    return jax.vmap(jax.vmap(pair, in_axes=(None, None, 0)),
                    in_axes=(0, 0, None))(d0, jnp.arange(P), jnp.arange(K))


def _close(a, b, what):
    """a == b to 1e-4 of each channel's (or column's) scale: pixel-unit
    reprojection entries reach ~1e3."""
    axes = tuple(range(b.ndim - 1)) if b.ndim > 3 else (0, 1)
    scale = np.maximum(np.abs(b).max(axis=axes), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-4,
                               err_msg=what)


def test_jacobians_match_jacfwd(win):
    pyrs, q, t, uv, d0, uv_obs, obs_ok = _t(
        win, "pyrs", "q", "t", "uv", "d0", "uv_obs", "obs_ok")
    chans = tba._channel_fn(pyrs, uv, q[0], t[0], 0, TCAM, (1, 2),
                            estimate_affine=True, gradient_weight=0.5,
                            uv_obs=uv_obs, obs_valid=obs_ok,
                            reproj_weight=4.0)
    g, o = torch.ones(K), torch.zeros(K)
    for l in (2, 1):
        rr, ww, Jt, Jd = tba._linearize(chans, q, t, g, o, l, d0, 8)
        jr, jw, jJt, jJd = (np.asarray(a) for a in _jax_jacobians(
            *_j(win, "pyrs", "q", "t", "uv", "d0", "uv_obs", "obs_ok"),
            jnp.int32(l)))
        # Port [K, P] layout -> JAX's [P, K].
        tJt = Jt.transpose(0, 1).numpy()
        tJd = Jd.transpose(0, 1).numpy()
        assert not np.isnan(tJt).any() and not np.isnan(tJd).any()
        np.testing.assert_array_equal(ww.transpose(0, 1).numpy(), jw)
        _close(rr.transpose(0, 1).numpy(), jr, f"r, level {l}")
        _close(tJt, jJt, f"Jt, level {l}")
        _close(tJd, jJd, f"Jd, level {l}")
        # The border points (the last four) are in view of some frame
        # and carry nonzero derivatives there.
        assert np.abs(tJt[-4:]).sum() > 0


def _check_ba(t, j, what):
    for k in ("q", "t", "idepths"):
        np.testing.assert_allclose(getattr(t, k).numpy(),
                                   np.asarray(getattr(j, k)), rtol=0,
                                   atol=1e-4, err_msg=f"{what}: {k}")
    np.testing.assert_allclose(float(t.final_cost), float(j.final_cost),
                               rtol=1e-4, err_msg=what)
    assert int(t.n_valid) == int(j.n_valid), what


def test_bundle_adjust_window_matches_jax(win):
    cases = (
        ("hybrid channels", dict(uv_obs="uv_obs", obs_valid="obs_ok")),
        ("photometric only", dict(estimate_affine=False,
                                  gradient_weight=0.0)))
    for what, kw in cases:
        jk = {k: jnp.asarray(win[v]) if isinstance(v, str) else v
              for k, v in kw.items()}
        tk = {k: torch.from_numpy(win[v]) if isinstance(v, str) else v
              for k, v in kw.items()}
        # ref_index=0 as hybrid_bundle_adjust passes it: one JAX compile
        # serves both tests.
        j = jba.bundle_adjust_window(*_j(win, *ARGS), ref_index=0,
                                     cam=JCAM, **LIVE, **jk)
        t = tba.bundle_adjust_window(*_t(win, *ARGS), cam=TCAM, **LIVE,
                                     **tk)
        _check_ba(t, j, what)
        # The solve moved the perturbed frames and kept the gauge.
        assert np.abs(t.q.numpy() - win["q"]).max() > 1e-5, what
        np.testing.assert_array_equal(t.t[0].numpy(), win["t"][0])


def test_gather_ba_inputs_bit_exact(rng):
    Kr, F, B = 8, 300, 64
    kf_valid = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    kf_ids = np.array([12, 15, 40, 3, 6, 9, 50, 0], np.int32)
    feat_valid = rng.random(F) > 0.3
    kf_idx = rng.integers(0, Kr, F).astype(np.int32)
    # Slot 1 (the newest, id 15) owns ~50 live features; some indices
    # lie outside [0, K): -1 wraps to slot 7, which then owns the most;
    # -9 and 8 count for no slot.
    kf_idx[:60] = 1
    kf_idx[200:290] = -1
    kf_idx[290:295] = -9
    kf_idx[295:] = 8
    uv = rng.uniform(0, 100, (F, 2)).astype(np.float32)
    mu = rng.uniform(0.2, 2.0, F).astype(np.float32)
    args = (kf_valid, kf_ids, feat_valid, kf_idx, uv, mu)
    ref = {}
    for anchor in ("newest", "most_owned"):
        j = np.asarray(jba.gather_ba_inputs(
            *(jnp.asarray(a) for a in args), budget=B, anchor=anchor))
        t = tba.gather_ba_inputs(*(torch.from_numpy(a) for a in args),
                                 budget=B, anchor=anchor).numpy()
        np.testing.assert_array_equal(t, j, err_msg=anchor)
        ref[anchor] = (int(t[2 * Kr]), int(t[2 * Kr + 1]))
    assert ref["newest"][0] == 1 and ref["newest"][1] >= 24, ref
    # The wrapped -1s make slot 7 the most owned, though the selection
    # then takes only the features whose index is 7 itself.
    assert ref["most_owned"][0] == 7 and ref["most_owned"][1] < 24, ref
    with pytest.raises(ValueError, match="anchor"):
        tba.gather_ba_inputs(*(torch.from_numpy(a) for a in args),
                             anchor="oldest")


def test_match_and_refine_match_jax(win):
    jargs = _j(win, "pyrs", "q", "t", "uv", "d0", "pv")
    targs = _t(win, "pyrs", "q", "t", "uv", "d0", "pv")

    def first(a):
        pyrs, q, t = a[:3]
        return (pyrs[0], q[0], t[0], pyrs, q, t, *a[3:])

    juv, jok = jba.match_window_points(*first(jargs), cam=JCAM)
    tuv, tok = tba.match_window_points(*first(targs), cam=TCAM)
    jok, tok = np.asarray(jok), tok.numpy()
    np.testing.assert_array_equal(tok, jok)
    assert 0.3 * P * (K - 1) < tok[:, 1:].sum(), tok.sum(0)
    np.testing.assert_allclose(tuv.numpy()[tok], np.asarray(juv)[jok],
                               rtol=0, atol=1e-3)
    j_ref, j_ok = jba.refine_matches_2d(jargs[0][0], jargs[3], jargs[0],
                                        juv, jnp.asarray(jok))
    t_ref, t_ok = tba.refine_matches_2d(targs[0][0], targs[3], targs[0],
                                        tuv, torch.from_numpy(tok))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_allclose(t_ref.numpy(), np.asarray(j_ref), rtol=0,
                               atol=1e-3)
    assert t_ok.numpy().sum() > 0.5 * tok.sum()


def test_presearch_and_hybrid_match_jax(win):
    # Poses further off: the discrete search has moves to make.
    off = dict(win)
    rng = np.random.default_rng(5)
    off["q"], off["t"] = win["q"].copy(), win["t"].copy()
    for k in (1, 3):
        T = (JSE3(jnp.asarray(win["q"][k]), jnp.asarray(win["t"][k]))
             @ JSE3.exp(jnp.asarray(rng.normal(0, 0.05, 6), jnp.float32)))
        off["q"][k], off["t"][k] = np.asarray(T.q), np.asarray(T.t)
    jq, jt = jba.discrete_pose_presearch(*_j(off, *ARGS), cam=JCAM)
    tq, tt = tba.discrete_pose_presearch(*_t(off, *ARGS), cam=TCAM)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=1e-5)
    assert np.abs(tq.numpy() - off["q"]).max() > 0.01      # it moved
    np.testing.assert_array_equal(tq[0].numpy(), off["q"][0])
    j = jba.hybrid_bundle_adjust(*_j(off, *ARGS), cam=JCAM, rounds=3,
                                 pre_search=True, **LIVE)
    t = tba.hybrid_bundle_adjust(*_t(off, *ARGS), cam=TCAM, rounds=3,
                                 pre_search=True, **LIVE)
    _check_ba(t, j, "hybrid rounds=3")


def test_sharded_ba_matches_unsharded_and_jax(win):
    """`hybrid_bundle_adjust_sharded` with the 64 points split over two
    CPU devices (["cpu", "cpu"]) against the port's unsharded one-round
    hybrid (`rounds=1`, the nodelet's call) and against the JAX package's
    `hybrid_bundle_adjust_sharded` on a two-device ("feat",) mesh, the
    same numpy inputs. Against the unsharded solve the two partial sums
    reduce in another order than the one einsum: q, t, idepths and gains
    to 1e-5 (the JAX test holds q and t to 2e-4, idepths to 5e-4), the
    final cost to 1e-5 relative, n_valid exactly, and the exposure
    offsets (gray levels, up to ~17 here; the JAX test does not hold
    them) to 1e-4 of their largest magnitude: measured 4.2e-5, the offset
    columns being the widest-scaled of the Jacobi-normalized system.
    Against JAX: `_check_ba`'s bounds. One device gives the unsharded
    solve bit for bit."""
    from jax.sharding import Mesh
    targs = _t(win, *ARGS)
    plain = tba.hybrid_bundle_adjust(*targs, cam=TCAM, rounds=1, **LIVE)
    two = tba.hybrid_bundle_adjust_sharded(["cpu", "cpu"], *targs,
                                           cam=TCAM, **LIVE)
    for k in ("q", "t", "idepths", "gains"):
        np.testing.assert_allclose(getattr(two, k).numpy(),
                                   getattr(plain, k).numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(two.final_cost),
                               float(plain.final_cost), rtol=1e-5)
    scale = max(1.0, float(plain.offsets.abs().max()))
    np.testing.assert_allclose(two.offsets.numpy() / scale,
                               plain.offsets.numpy() / scale, rtol=0,
                               atol=1e-4)
    assert int(two.n_valid) == int(plain.n_valid)
    assert np.abs(two.q.numpy() - win["q"]).max() > 1e-5   # it moved
    one = tba.hybrid_bundle_adjust_sharded(["cpu"], *targs, cam=TCAM,
                                           **LIVE)
    for a, b in zip(one, plain):
        assert torch.equal(a, b)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("feat",))
    j = jba.hybrid_bundle_adjust_sharded(mesh, *_j(win, *ARGS), cam=JCAM,
                                         **LIVE)
    _check_ba(two, j, "sharded vs JAX sharded")
    with pytest.raises(ValueError, match="split"):
        tba.hybrid_bundle_adjust_sharded(["cpu"] * 3, *targs, cam=TCAM,
                                         **LIVE)


def test_nodelet_routes_ba_through_sharded_solver(win, monkeypatch):
    """pose_tracking.ba_sharded=True routes the nodelet's windowed BA
    through `hybrid_bundle_adjust_sharded` (a spy, as
    tests/test_nodelet.py:194), over the one CPU device, and the refined
    keyframe poses equal ba_sharded=False's bit for bit. The window is
    this file's, written into the engine's state (the 60 points owned by
    keyframe slot 0, the "most_owned" anchor)."""
    from flame_ros_torch.config import FlameParams
    from flame_ros_torch.frontends import nodelet as nodelet_mod
    calls = []
    orig = nodelet_mod.hybrid_bundle_adjust_sharded

    def spy(devices, *a, **kw):
        calls.append(list(devices))
        return orig(devices, *a, **kw)

    monkeypatch.setattr(nodelet_mod, "hybrid_bundle_adjust_sharded", spy)
    poses = {}
    for sharded in (False, True):
        params = FlameParams.from_dict({
            "engine": {"max_features": 256, "max_keyframes": K},
            "pose_tracking": {"ba_sharded": sharded, "ba_budget": P,
                              "ba_anchor": "most_owned"}})
        node = nodelet_mod.FlameNodelet(TCAM, params, pose_source="tracking",
                                        ba_refine=True, device="cpu")
        st = node.engine.state
        n = st.feat.valid.shape[0]
        uv = torch.zeros(n, 2)
        uv[:P] = torch.from_numpy(win["uv"])
        mu = torch.full((n,), 0.5)
        mu[:P] = torch.from_numpy(win["d0"])
        node.engine.state = st._replace(
            kf_pyrs=torch.from_numpy(win["pyrs"]),
            kf_q=torch.from_numpy(win["q"]), kf_t=torch.from_numpy(win["t"]),
            kf_valid=torch.ones(K, dtype=torch.bool),
            kf_ids=torch.tensor(KF, dtype=st.kf_ids.dtype),
            feat=st.feat._replace(
                uv_ref=uv, mu=mu, valid=torch.arange(n) < P,
                kf_idx=torch.zeros(n, dtype=st.feat.kf_idx.dtype)))
        node._ba_refine()
        assert len(node.ba_costs) == 1
        poses[sharded] = (node.engine.state.kf_q, node.engine.state.kf_t,
                          node.ba_costs[0])
        node.engine.shutdown()
    assert calls == [[torch.device("cpu")]]
    assert torch.equal(poses[True][0], poses[False][0])
    assert torch.equal(poses[True][1], poses[False][1])
    assert poses[True][2] == poses[False][2]
    assert not torch.equal(poses[True][0], torch.from_numpy(win["q"]))
