"""The port's viz modules (flame_ros_torch/ops/colormap.py,
viz/{debug_images,export,html_viewer,live_viewer}.py) held against the
JAX package's on the CPU.

The host code (colormaps, drawings, PLY and HTML export) must give the
same bytes on the same seeded numpy inputs; `jet` runs on tensors and is
held to 1e-7. The debug products of a 96x128 port engine after 7 frames
go through both packages' `render_debug_images`: JAX's is host code that
only reads the engine's getters, so it runs on the port's engine and no
JAX engine is built. The live viewer is driven against the port's
FlameServer as tests/test_live_viewer.py drives the JAX package's.
"""
import json
import socket
import time
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flame_ros_tpu.ops import colormap as jcm
from flame_ros_tpu.viz import debug_images as jdbg
from flame_ros_tpu.viz import export as jexp
from flame_ros_tpu.viz import html_viewer as jhtml
from flame_ros_torch.config import FlameParams
from flame_ros_torch.datasets.synthetic import make_sequence
from flame_ros_torch.frontends.serve import FlameServer, send_msg
from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.geometry.se3 import SE3
from flame_ros_torch.models.engine import Flame
from flame_ros_torch.ops import colormap as tcm
from flame_ros_torch.ops.epipolar import STATUS_MAX_COST, STATUS_OK
from flame_ros_torch.viz import debug_images as tdbg
from flame_ros_torch.viz import export as texp
from flame_ros_torch.viz import html_viewer as thtml
from flame_ros_torch.viz.live_viewer import LiveMeshViewer

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W = 96, 128
CAM = Pinhole(105.0, 105.0, 63.5, 47.5, W, H)
FLAGS = ("wireframe", "features", "idepthmap", "matches", "detections",
         "normals")
SMALL = {"engine": {"max_features": 256, "max_keyframes": 4},
         "debug": dict.fromkeys(FLAGS, True)}


@pytest.fixture(scope="module")
def run():
    """A port engine after 7 frames (a poseframe at 0 and 6) and the last
    frame's gray image."""
    seq = make_sequence(7, CAM, motion="strafe", device="cpu")
    eng = Flame(W, H, cam=CAM, params=FlameParams.from_dict(SMALL),
                device="cpu")
    for i in range(7):
        assert eng.update(float(seq.timestamps[i]), i,
                          SE3(seq.poses.q[i], seq.poses.t[i]),
                          seq.images[i].numpy(), i % 6 == 0)
    eng.flush_stats()
    return eng, seq.images[6].numpy()


def test_jet_matches_jax():
    v = np.random.default_rng(0).uniform(-0.5, 1.5, (64, 3)).astype(
        np.float32)
    for lo, hi in ((0.0, 1.0), (-0.2, 0.7), (0.5, 0.5)):
        np.testing.assert_allclose(
            tcm.jet(torch.from_numpy(v), lo, hi).numpy(),
            np.asarray(jcm.jet(jnp.asarray(v), lo, hi)), atol=1e-7)
    np.testing.assert_allclose(tcm.jet(0.25).numpy(),
                               np.asarray(jcm.jet(jnp.asarray(0.25))),
                               atol=1e-7)


def test_host_colormaps_and_drawings_bit_exact():
    rng = np.random.default_rng(1)
    vals = rng.uniform(-0.3, 1.3, (H, W))
    vals[rng.random((H, W)) < 0.3] = np.nan
    fin = vals[np.isfinite(vals)]
    np.testing.assert_array_equal(tcm.jet_u8(fin, 0.1, 0.9),
                                  jcm.jet_u8(fin, 0.1, 0.9))
    base = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tcm.apply_colormap_over(base, vals, 0.0, 1.0),
        jcm.apply_colormap_over(base, vals, 0.0, 1.0))

    gray = rng.uniform(0, 255, (H, W)).astype(np.float32)
    uv = rng.uniform(0, [W - 1, H - 1], (40, 2)).astype(np.float32)
    x = rng.uniform(0.1, 1.2, 40).astype(np.float32)
    tris = rng.integers(0, 40, (30, 3)).astype(np.int32)
    keep = rng.random(30) < 0.7
    valid = rng.random(40) < 0.8
    uv2 = uv + rng.normal(0, 3, uv.shape).astype(np.float32)
    status = rng.choice([0, STATUS_OK, STATUS_MAX_COST], 40)
    imap = np.where(rng.random((H, W)) < 0.6, vals, np.nan)
    nmap = rng.normal(0, 1, (H, W, 3)).astype(np.float32)
    nmap /= np.linalg.norm(nmap, axis=-1, keepdims=True)
    for flip in (False, True):
        for name, args, kw in (
                ("draw_wireframe", (gray, uv, x, tris, keep),
                 dict(color_scale=0.8, text="feats:40")),
                ("draw_features", (gray, uv, x, valid),
                 dict(color_scale=1.2, text="t")),
                ("draw_detections", (gray, uv, valid), {}),
                ("draw_matches", (gray, uv, uv2, status, valid), {}),
                ("draw_idepthmap", (gray, imap),
                 dict(color_scale=0.9, vmax=1.1, text="cov")),
                ("draw_normals", (gray, imap, nmap), {})):
            np.testing.assert_array_equal(
                getattr(tdbg, name)(*args, flip=flip, **kw),
                getattr(jdbg, name)(*args, flip=flip, **kw),
                err_msg=f"{name} flip={flip}")


def test_render_debug_images_matches_jax(run):
    """JAX's render_debug_images and the port's on the same port engine:
    all six products, bit for bit (the matches product reads the engine's
    last epipolar matches)."""
    eng, gray = run
    assert eng._dev_uv_match is not None
    got = tdbg.render_debug_images(eng, gray)
    want = jdbg.render_debug_images(eng, gray)
    assert sorted(got) == sorted(want) == sorted(FLAGS)
    for k in FLAGS:
        assert got[k].shape == (H, W, 3) and got[k].dtype == np.uint8
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # The matches product draws the stored matches, not the vertices.
    assert not np.array_equal(eng._dev_uv_match.numpy(),
                              eng.state.vtx_uv.numpy())


def test_exports_match_jax(run, tmp_path):
    """PLY mesh and cloud files byte for byte, the HTML page string
    equal."""
    eng, gray = run
    uv, x, normals, tris, keep, _ = eng.get_inverse_depth_mesh()
    assert keep.sum() > 0
    rgb = np.stack([gray.astype(np.uint8)] * 3, -1)
    for name, mod in (("port", texp), ("jax", jexp)):
        mod.write_ply_mesh(str(tmp_path / f"{name}.ply"), uv, x, normals,
                           tris, keep, CAM.K, rgb=rgb, width=W, height=H)
        imap = eng.get_inverse_depth_map()
        mod.write_ply_cloud(str(tmp_path / f"{name}_cloud.ply"),
                            mod.depthmap_to_cloud(imap, CAM.K, 0.1, 8.0))
    for suffix in (".ply", "_cloud.ply"):
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes()
    for live in (0, 250):
        page = thtml.render_page(thtml.mesh_viewer_data(
            uv, x, normals, tris, keep, CAM.K, gray=gray), live)
        assert page == jhtml.render_page(jhtml.mesh_viewer_data(
            uv, x, normals, tris, keep, CAM.K, gray=gray), live)
    out = thtml.export_html_viewer(str(tmp_path / "m.html"), uv, x, normals,
                                   tris, keep, CAM.K, gray=gray)
    jhtml.export_html_viewer(str(tmp_path / "j.html"), uv, x, normals,
                             tris, keep, CAM.K, gray=gray)
    assert open(out).read() == (tmp_path / "j.html").read_text()


def test_live_viewer_streams_growing_mesh():
    """The port's live viewer polling the port's FlameServer on the CPU
    (tests/test_live_viewer.py:75): the page serves at once with its
    polling loop, and the mesh JSON fills as frames stream in."""
    seq = make_sequence(8, CAM, motion="strafe", device="cpu")
    imgs = torch.clamp(seq.images, 0, 255).to(torch.uint8).numpy()
    srv = FlameServer(CAM, FlameParams.from_dict(
        {"engine": {"max_features": 256, "max_keyframes": 4}}), port=0,
        device="cpu")
    srv.start()
    viewer = LiveMeshViewer(server_port=srv.port, http_port=0,
                            period_s=0.2).start()
    c = socket.create_connection(("127.0.0.1", srv.port))
    base = f"http://127.0.0.1:{viewer.http_port}"
    try:
        with urllib.request.urlopen(base + "/", timeout=5) as r:
            page = r.read()
        assert r.status == 200
        assert b"mesh.json" in page and b"setMesh" in page
        for i in range(8):
            send_msg(c, {"type": "frame", "img_id": i,
                         "time": float(seq.timestamps[i]),
                         "quat": seq.poses.q[i].tolist(),
                         "trans": seq.poses.t[i].tolist(),
                         "shape": [H, W], "dtype": "uint8"},
                     imgs[i].tobytes())
        deadline = time.time() + 30
        d = None
        while time.time() < deadline:
            with urllib.request.urlopen(base + "/mesh.json",
                                        timeout=5) as r:
                if r.status == 200:
                    d = json.loads(r.read())
                    if len(d["xyz"]) >= 9 and len(d["tris"]) >= 3:
                        break
            time.sleep(0.3)
        assert d is not None and len(d["tris"]) >= 3, d and len(d["tris"])
        assert d["stamp"] >= 1
        assert np.isfinite(np.asarray(d["xyz"])).all()
    finally:
        try:
            send_msg(c, {"type": "stop"})
            c.close()
        except OSError:
            pass
        viewer.stop()
        srv.stop()
