"""The port's server, dataset loaders, live-stream helpers and dataset CLI
routes, on the CPU.

- FlameServer round trip on 127.0.0.1 (no network): every stats message,
  the idepth map equal to the serving engine's, the mesh NPZ with K, a
  pose-graph message, an erroneous client that ends only its own
  connection, and stop() closing the live connections.
- The TUM and ASL loaders, `associate`, the frame conventions,
  `PoseTable`, `TrackedImageStream`, `undistort_maps` and
  `remap_bilinear` against the JAX package's (host numpy on both sides)
  on trees and inputs written here: arrays exactly equal, poses to 1e-6
  where the port's SE3 normalizes in f32 torch.
- `offline_runner.main` over a TUM and an ASL tree prints the JAX
  runner's summary keys; the argument checks; the rate throttle and the
  truth harness on the CLI.
- The host leftovers: `export_tum`/`export_asl` write the JAX package's
  trees byte for byte, `truth_stats` equals its counts (floats to 1e-6
  relative), and `load_stats_file` reads a written stats.txt back as
  the JAX loader does.
"""
import io
import json
import socket
import time

import numpy as np
import pytest
import torch
import yaml

from flame_ros_tpu.datasets import asl as jasl
from flame_ros_tpu.datasets import synthetic as jsyn
from flame_ros_tpu.datasets import tum as jtum
from flame_ros_tpu.datasets.associate import associate as jassociate
from flame_ros_tpu.geometry import camera as jcam
from flame_ros_tpu.eval import metrics as jmet
from flame_ros_tpu.geometry import frames as jframes
from flame_ros_tpu.geometry.se3 import SE3 as JSE3
from flame_ros_tpu.streams import live as jlive
from flame_ros_torch.config import FlameParams
from flame_ros_torch.datasets import asl as tasl
from flame_ros_torch.datasets import tum as ttum
from flame_ros_torch.datasets.associate import associate as tassociate
from flame_ros_torch.datasets.synthetic import (export_asl, export_tum,
                                                make_sequence)
from flame_ros_torch.eval import metrics as tmet
from flame_ros_torch.frontends import offline_runner
from flame_ros_torch.frontends.serve import FlameServer, recv_msg, send_msg
from flame_ros_torch.geometry import camera as tcam
from flame_ros_torch.geometry import frames as tframes
from flame_ros_torch.geometry.se3 import SE3
from flame_ros_torch.streams import live as tlive

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W = 96, 128
CAM = tcam.Pinhole(105.0, 105.0, 63.5, 47.5, W, H)
SMALL = {"engine": {"max_features": 256, "max_keyframes": 4}}
N = 6
# JAX offline_runner's summary line (external poses).
SUMMARY_KEYS = {"frames", "failed", "fps", "idepth_rmse", "precision",
                "recall", "coverage", "abs_rel", "delta1"}


def _T_BS(rot_z_deg, t):
    c, s = np.cos(np.radians(rot_z_deg)), np.sin(np.radians(rot_z_deg))
    T = np.eye(4)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = t
    return {"rows": 4, "cols": 4, "data": T.ravel().tolist()}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """N synthetic 96x128 frames written as a TUM tree (association file,
    RGB + 16-bit depth PNGs, a CameraInfo YAML with distortion and one
    without) and an EuRoC/ASL tree (camera, depth and pose folders with
    non-trivial extrinsics)."""
    import cv2
    root = tmp_path_factory.mktemp("datasets")
    s = make_sequence(N, CAM, motion="strafe", device="cpu")
    g = s.images.numpy()
    rgb = np.clip(np.stack([g, g + 12.0, g - 9.0], -1), 0, 255).astype(
        np.uint8)
    d16 = np.round(s.depths.numpy() * 5000.0).astype(np.uint16)
    q, t = s.poses.q.numpy(), s.poses.t.numpy()
    tum = root / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    lines = []
    for i in range(N):
        cv2.imwrite(str(tum / "rgb" / f"{i}.png"), rgb[i][..., ::-1])
        cv2.imwrite(str(tum / "depth" / f"{i}.png"), d16[i])
        ts = 100.0 + float(s.timestamps[i])
        (qw, qx, qy, qz), (tx, ty, tz) = q[i].tolist(), t[i].tolist()
        lines.append(f"{ts} {tx} {ty} {tz} {qx} {qy} {qz} {qw} {ts} "
                     f"rgb/{i}.png {ts} depth/{i}.png")
    (tum / "assoc.txt").write_text("\n".join(lines) + "\n")
    K = CAM.K.astype(np.float64)
    for name, dist in (("calib.yaml", [0.0] * 5),
                       ("calib_dist.yaml", [0.05, -0.02, 0.001, -0.002, 0])):
        (tum / name).write_text(yaml.safe_dump({
            "image_width": W, "image_height": H,
            "camera_matrix": {"data": (K * [[1.01], [0.99], [1]]).ravel()
                              .tolist()},
            "projection_matrix": {"data": np.hstack(
                [K, np.zeros((3, 1))]).ravel().tolist()},
            "distortion_coefficients": {"data": dist}}))
    asl = root / "mav0"
    dirs = {k: asl / k for k in ("cam0", "depth0", "pose0")}
    for k in ("cam0", "depth0"):
        (dirs[k] / "data").mkdir(parents=True)
    dirs["pose0"].mkdir()
    (dirs["cam0"] / "sensor.yaml").write_text(yaml.safe_dump({
        "sensor_type": "camera", "T_BS": _T_BS(5.0, [0.1, 0.0, 0.02]),
        "intrinsics": [CAM.fx, CAM.fy, CAM.cx, CAM.cy],
        "resolution": [W, H],
        "distortion_coefficients": [0.01, -0.005, 0.0, 0.0]}))
    (dirs["depth0"] / "sensor.yaml").write_text(yaml.safe_dump({
        "sensor_type": "camera", "T_BS": _T_BS(5.0, [0.1, 0.0, 0.02]),
        "depth_scale_factor": 5000.0}))
    (dirs["pose0"] / "sensor.yaml").write_text(yaml.safe_dump({
        "sensor_type": "visual-inertial",
        "T_BS": _T_BS(-3.0, [0.0, 0.05, 0.0])}))
    cam_rows, pose_rows = [], []
    for i in range(N):
        ns = 1_000_000_000 + i * 33_333_333
        cv2.imwrite(str(dirs["cam0"] / "data" / f"{ns}.png"), rgb[i, ..., 0])
        cv2.imwrite(str(dirs["depth0"] / "data" / f"{ns}.png"), d16[i])
        cam_rows.append(f"{ns},{ns}.png")
        (qw, qx, qy, qz), (tx, ty, tz) = q[i].tolist(), t[i].tolist()
        pose_rows.append(f"{ns + 1000},{tx},{ty},{tz},{qw},{qx},{qy},{qz}")
    for k, rows in (("cam0", cam_rows), ("depth0", cam_rows),
                    ("pose0", pose_rows)):
        (dirs[k] / "data.csv").write_text("#ts,data\n" + "\n".join(rows)
                                          + "\n")
    cfg = root / "small.yaml"
    cfg.write_text(yaml.safe_dump(SMALL))
    return dict(tum=tum, asl=dirs, cfg=cfg, seq=s)


def _same_frames(tf, jf):
    assert len(tf) == len(jf) > 0
    for a, b in zip(tf, jf):
        assert (a.img_id, a.time) == (b.img_id, b.time)
        for k in ("rgb", "gray", "depth", "quat", "trans"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
            assert getattr(a, k).dtype == getattr(b, k).dtype, k


def test_tum_loader_matches_jax(trees):
    tum = trees["tum"]
    assoc = str(tum / "assoc.txt")
    for calib, frame, resize in ((None, "RDF", 1),
                                 ("calib.yaml", "FLU", 1),
                                 ("calib_dist.yaml", "RDF_IN_FRD", 2)):
        kw = dict(input_frame=frame, resize_factor=resize)
        if calib is not None:
            tc = ttum.load_camera_info_yaml(str(tum / calib))
            jc = jtum.load_camera_info_yaml(str(tum / calib))
            assert tc.cam.__dict__ == jc.cam.__dict__
            np.testing.assert_array_equal(tc.dist_coeffs, jc.dist_coeffs)
            np.testing.assert_array_equal(tc.raw_K, jc.raw_K)
        ts = ttum.TUMRGBDStream(assoc, calib=tc if calib else None, **kw)
        js = jtum.TUMRGBDStream(assoc, calib=jc if calib else None, **kw)
        assert ts.cam.__dict__ == js.cam.__dict__
        _same_frames(list(ts), list(js))
    with pytest.raises(ValueError):
        ttum.TUMRGBDStream(assoc, input_frame="RFU")
    (tum / "rgb.txt").write_text("1.00 rgb/0.png\n2.00 rgb/1.png\n")
    (tum / "groundtruth.txt").write_text(
        "1.001 0 0 0 0 0 0 1\n2.005 1 0 0 0 0 0 1\n")
    assert ttum.build_associations(str(tum)) == \
        jtum.build_associations(str(tum))


def test_asl_loader_matches_jax(trees):
    d = {k: str(v) for k, v in trees["asl"].items()}
    for world, depth, resize in (("RDF", True, 1), ("FLU", False, 1),
                                 ("RFU", True, 2)):
        kw = dict(depth_path=d["depth0"] if depth else None,
                  world_frame=world, resize_factor=resize)
        ts = tasl.ASLRGBDStream(d["pose0"], d["cam0"], **kw)
        js = jasl.ASLRGBDStream(d["pose0"], d["cam0"], **kw)
        assert len(ts) == len(js) == N
        assert ts.cam.__dict__ == js.cam.__dict__
        _same_frames(list(ts), list(js))
    for k in ("cam0", "pose0"):
        tr = tasl.ASLSensor.read(d[k]).typed_records()
        jr = jasl.ASLSensor.read(d[k]).typed_records()
        assert [type(x).__name__ for x in tr] == \
            [type(x).__name__ for x in jr]
        for a, b in zip(tr, jr):
            for f, v in a.__dict__.items():
                np.testing.assert_array_equal(v, getattr(b, f))


def test_host_helpers_match_jax(rng):
    ta, tb = rng.uniform(0, 5, 40), rng.uniform(0, 5, 30)
    for max_diff in (0.02, 0.1):
        for x, y in zip(tassociate(ta, tb, max_diff),
                        jassociate(ta, tb, max_diff)):
            np.testing.assert_array_equal(x, y)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    t = rng.normal(size=3)
    for f in jframes.TUM_FRAMES:
        for x, y in zip(tframes.to_rdf(q, t, f), jframes.to_rdf(q, t, f)):
            np.testing.assert_array_equal(x, y)
    for f in jframes.ASL_FRAMES:
        for x, y in zip(tframes.world_to_rdf(q, t, f),
                        jframes.world_to_rdf(q, t, f)):
            np.testing.assert_array_equal(x, y)
    assert tframes.TUM_FRAMES == jframes.TUM_FRAMES
    assert tframes.ASL_FRAMES == jframes.ASL_FRAMES

    jc = jcam.Pinhole(CAM.fx, CAM.fy, CAM.cx, CAM.cy, W, H)
    assert CAM.scaled(2).__dict__ == jc.scaled(2).__dict__
    np.testing.assert_array_equal(CAM.Kinv, jc.Kinv)
    dist = [0.05, -0.02, 0.001, -0.002, 0.003]
    raw_K = CAM.K.astype(np.float64) * [[1.02], [0.98], [1]]
    maps = tcam.undistort_maps(CAM, dist, raw_K=raw_K)
    for x, y in zip(maps, jcam.undistort_maps(jc, dist, raw_K=raw_K)):
        np.testing.assert_array_equal(x, y)
    for img in (rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
                rng.uniform(0, 255, (H, W)).astype(np.float32)):
        a, b = tcam.remap_bilinear(img, *maps), jcam.remap_bilinear(img,
                                                                    *maps)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype

    tp, jp = tlive.PoseTable(maxlen=4), jlive.PoseTable(maxlen=4)
    for k in range(6):
        qk = rng.normal(size=4)
        qk /= np.linalg.norm(qk)
        tk = rng.normal(size=3)
        tp.add(float(k), qk, tk)
        jp.add(float(k), qk, tk)
    for when in (0.5, 2.0, 2.25, 4.9, 5.0, 5.1):
        a, b = tp.lookup(when), jp.lookup(when)
        assert (a is None) == (b is None), when
        if a is not None:
            np.testing.assert_allclose(a.q.numpy(), np.asarray(b.q),
                                       atol=1e-6)
            np.testing.assert_allclose(a.t.numpy(), np.asarray(b.t),
                                       atol=1e-6)
    assert tp.lookup(5.1, max_extrapolation=0.2) is not None
    got = {"t": [], "j": []}
    ts = tlive.TrackedImageStream(CAM, tp, lambda *a: got["t"].append(a)
                                  or True, dist_coeffs=dist, resize_factor=2)
    js = jlive.TrackedImageStream(jc, jp, lambda *a: got["j"].append(a)
                                  or True, dist_coeffs=dist, resize_factor=2)
    assert ts.cam.__dict__ == js.cam.__dict__
    rgb = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 4, (H, W)).astype(np.float32)
    for when in (0.5, 3.5, 4.5):
        assert ts.image_callback(when, rgb, depth) == \
            js.image_callback(when, rgb, depth)
    assert ts.num_pose_failures == js.num_pose_failures == 1
    for a, b in zip(got["t"], got["j"]):
        assert a[:2] == b[:2]
        np.testing.assert_allclose(a[2], b[2], atol=1e-6)
        np.testing.assert_allclose(a[3], b[3], atol=1e-6)
        np.testing.assert_array_equal(a[4], b[4])
        np.testing.assert_array_equal(a[5], b[5])
        assert a[4].shape == (H // 2, W // 2)


def test_exporters_and_truth_stats_match_jax(tmp_path, rng):
    """export_tum / export_asl write the JAX package's trees file by file
    from the same frames; truth_stats equals the JAX package's; a
    stats.txt written by StatsFileWriter loads back (load_stats_file) as
    the JAX package's loader reads it."""
    s = make_sequence(3, CAM, motion="strafe", device="cpu")
    js = jsyn.SyntheticSequence(
        cam=jcam.Pinhole(CAM.fx, CAM.fy, CAM.cx, CAM.cy, W, H),
        images=s.images.numpy(), depths=s.depths.numpy(),
        poses=JSE3(s.poses.q.numpy(), s.poses.t.numpy()),
        timestamps=s.timestamps)
    for name, tfn, jfn in (("tum", export_tum, jsyn.export_tum),
                           ("asl", export_asl, jsyn.export_asl)):
        a, b = tmp_path / f"{name}_port", tmp_path / f"{name}_jax"
        tfn(s, str(a))
        jfn(js, str(b))
        fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
        fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
        assert fa == fb and len(fa) >= 7, (name, fa, fb)
        for f in fa:
            assert (a / f).read_bytes() == (b / f).read_bytes(), (name, f)

    idepths = rng.uniform(0.2, 2.0, (H, W)).astype(np.float32)
    idepths[rng.random((H, W)) < 0.3] = np.nan
    depth = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.2] = 0.0
    a, b = tmet.truth_stats(idepths, depth), jmet.truth_stats(idepths, depth)
    for k in ("true_pos", "true_neg", "false_pos", "false_neg"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("total_error", "avg_error", "precision", "recall", "rmse"):
        assert getattr(a, k) == pytest.approx(getattr(b, k), rel=1e-6), k
    np.testing.assert_allclose(a.idepth_error, np.asarray(b.idepth_error),
                               rtol=1e-6, equal_nan=True)

    w = tmet.StatsFileWriter(str(tmp_path / "stats"))
    for i in range(4):
        w.append(i, 0.1 * i, 12.5 + i, 100 + i, 180 + i, a, 1.25 * i, 0.5)
    got, ref = tmet.load_stats_file(w.path), jmet.load_stats_file(w.path)
    assert list(got) == list(ref) == list(tmet.STATS_COLUMNS)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(got["num_vtx"], [100, 101, 102, 103])
    assert got["true_pos"].tolist() == [a.true_pos] * 4
    np.testing.assert_allclose(got["timestamp"], [0.0, 0.1, 0.2, 0.3])
    empty = tmp_path / "empty.txt"
    empty.write_text(" ".join(tmet.STATS_COLUMNS) + "\n")
    assert all(v.size == 0 for v in tmet.load_stats_file(str(empty)).values())


def test_server_round_trip():
    s = make_sequence(8, CAM, device="cpu")
    srv = FlameServer(CAM, FlameParams.from_dict(SMALL), port=0,
                      device="cpu")
    srv.start()
    conns = []

    def connect():
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        conns.append(c)
        return c

    try:
        c, poller = connect(), connect()
        imgs = np.clip(s.images.numpy(), 0, 255).astype(np.uint8)
        q, t = s.poses.q.numpy(), s.poses.t.numpy()
        for i in range(8):
            send_msg(c, {"type": "frame", "img_id": i,
                         "time": float(s.timestamps[i]),
                         "quat": q[i].tolist(), "trans": t[i].tolist(),
                         "shape": [H, W], "dtype": "uint8"},
                     imgs[i].tobytes())
        stats = []
        while len(stats) < 8:
            h, _ = recv_msg(c)
            assert h is not None, "server closed early"
            if h["type"] == "stats":
                stats.append(h)
        assert [h["img_id"] for h in stats] == list(range(8))
        assert stats[-1]["num_feats"] > 50 and stats[-1]["queue_size"] == 0

        def reply(conn, want):
            while True:
                h, payload = recv_msg(conn)
                if h["type"] == want:
                    return h, payload

        send_msg(poller, {"type": "get_mesh"})
        _, payload = reply(poller, "mesh")
        mesh = np.load(io.BytesIO(payload))
        assert mesh["triangles"].shape[1] == 3 and len(mesh["idepths"]) > 50
        np.testing.assert_array_equal(mesh["K"], CAM.K)
        send_msg(c, {"type": "get_idepth"})
        h, payload = reply(c, "idepth")
        m = np.frombuffer(payload, np.float32).reshape(h["shape"])
        np.testing.assert_array_equal(
            m, srv.node.engine.get_inverse_depth_map())
        assert np.isfinite(m).mean() > 0.2
        # A pose-graph message moves the live poseframes' poses.
        ids = srv.node.engine.state.kf_ids.tolist()[:2]
        moved = SE3.from_quat_trans(q[ids], t[ids] + 0.01)
        send_msg(c, {"type": "poseframes", "ids": ids, "poses": np.hstack(
            [moved.q.numpy(), moved.t.numpy()]).tolist()})
        send_msg(c, {"type": "get_idepth"})
        reply(c, "idepth")
        np.testing.assert_array_equal(
            srv.node.engine.state.kf_t[:2].numpy(), moved.t.numpy())
        # An error of any kind (here a TypeError) ends only its own
        # connection.
        bad = connect()
        send_msg(bad, {"type": "frame", "img_id": 9, "time": 0.0,
                       "quat": [1, 0, 0, 0], "trans": [0, 0, 0],
                       "shape": "not a shape"}, b"\0" * 4)
        assert recv_msg(bad)[0] is None
        send_msg(c, {"type": "get_idepth"})
        reply(c, "idepth")
    finally:
        srv.stop()
    # stop() closes the live connections: both clients read EOF.
    for conn in (c, poller):
        while True:
            h, _ = recv_msg(conn)
            if h is None:
                break
    for conn in conns:
        conn.close()


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_dataset_cli_routes(trees, tmp_path, capsys):
    tum, d, cfg = trees["tum"], trees["asl"], str(trees["cfg"])
    common = ["--config", cfg, "--device", "cpu"]
    res = offline_runner.main_tum(
        ["--input", str(tum / "assoc.txt"), "--calib",
         str(tum / "calib.yaml"), "--out", str(tmp_path / "tum")] + common)
    summary = _summary(capsys)
    assert set(summary) == SUMMARY_KEYS and summary["frames"] == N
    assert res.frames_failed == 0 and np.isfinite(res.mean_rmse)
    assert (tmp_path / "tum" / "stats.txt").exists()
    res = offline_runner.main_asl(
        ["--pose-path", str(d["pose0"]), "--rgb-path", str(d["cam0"]),
         "--depth-path", str(d["depth0"])] + common)
    summary = _summary(capsys)
    assert set(summary) == SUMMARY_KEYS and summary["frames"] == N
    assert res.frames_failed == 0 and np.isfinite(res.mean_rmse)
    for bad in (["--dataset", "tum"], ["--dataset", "asl", "--rgb-path", "x"],
                ["--dataset", "synthetic", "--window", "3",
                 "--pass-in-truth"],
                ["--dataset", "synthetic", "--window", "3", "--rate", "5"]):
        with pytest.raises(SystemExit):
            offline_runner.main(bad + common)
    capsys.readouterr()
    # The truth harness and the rate throttle on the CLI.
    t0 = time.perf_counter()
    res = offline_runner.main(["--dataset", "synthetic", "--frames", "4",
                               "--pass-in-truth", "--rate", "20"] + common)
    assert time.perf_counter() - t0 >= 3 / 20
    assert set(_summary(capsys)) == SUMMARY_KEYS
    assert res.frames_processed == 4 and np.isfinite(res.mean_rmse)
