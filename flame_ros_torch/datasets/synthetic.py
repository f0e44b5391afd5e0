"""Synthetic posed RGB-D sequence renderer (textured room scene).

Counterpart of `flame_ros_tpu/datasets/synthetic.py`: a deterministic
source of grayscale frames + exact depth + exact 6-DoF poses. Bounded
textured planes (and, in the "primitives" scene, spheres) are ray-cast
analytically on the port's device: with RDF camera rays r = Kinv (u,v,1)
(z = 1) the hit parameter along the world ray equals camera z-depth, so
depth maps are exact. Textures are multi-octave value noise whose random
tables come from numpy generators seeded per plane — the same tables as
the JAX package's.

A sequence gives the engine the same frames on every device, so that a
run on the card reads the frames the JAX package's reference runs read
on the CPU: trajectories are made on the host; dot products are written
out term by term; a division by a constant divides by a tensor (the
card multiplies by the reciprocal of a Python scalar divisor, one ulp
away); the spheres (intersection, atan2 and asin of the texture) run in
float64 and round to float32. `chip_smoke.py` holds every frame that
its phases 4 and 14 read on the card to the CPU's rendering of it, bit
for bit (image, depth and pose).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.geometry.se3 import SE3
from flame_ros_torch.utils.device import resolve_device

VGA = Pinhole(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
QVGA = Pinhole(fx=262.5, fy=262.5, cx=159.5, cy=119.5, width=320, height=240)


def _plane(p, n, tu, tv, eu, ev, seed):
    return (np.array(p, np.float32), np.array(n, np.float32),
            np.array(tu, np.float32), np.array(tv, np.float32),
            np.float32(eu), np.float32(ev), seed)


def _room_planes():
    """(point, normal, tangent_u, tangent_v, half_u, half_v, tex_seed)."""
    return [
        _plane([0, 0, 4.0], [0, 0, -1], [1, 0, 0], [0, 1, 0], 3.0, 2.0, 1),
        _plane([-2.5, 0, 2.0], [1, 0, 0], [0, 0, 1], [0, 1, 0], 3.0, 2.0, 2),
        _plane([2.5, 0, 2.0], [-1, 0, 0], [0, 0, 1], [0, 1, 0], 3.0, 2.0, 3),
        _plane([0, 1.5, 2.0], [0, -1, 0], [1, 0, 0], [0, 0, 1], 3.0, 3.0, 4),
        _plane([0, -1.5, 2.0], [0, 1, 0], [1, 0, 0], [0, 0, 1], 3.0, 3.0, 5),
        _plane([0.6, 0.9, 2.2], [0, 0, -1], [1, 0, 0], [0, 1, 0], 0.6, 0.6,
               6),
        _plane([0.6, 0.3, 2.5], [0, -1, 0], [1, 0, 0], [0, 0, 1], 0.6, 0.3,
               7),
        _plane([-1.0, -0.2, 2.8], [0.5547, 0, -0.83205],
               [0.83205, 0, 0.5547], [0, 1, 0], 0.7, 0.7, 8),
    ]


def _primitive_planes():
    """Floating boxes over a back wall + floor (depth discontinuities)."""
    out = [
        _plane([0, 0, 4.5], [0, 0, -1], [1, 0, 0], [0, 1, 0], 3.4, 2.4, 11),
        _plane([0, 1.6, 2.4], [0, -1, 0], [1, 0, 0], [0, 0, 1], 3.4, 3.4, 12),
    ]
    boxes = [
        ((-0.9, 0.45, 1.9), (0.35, 0.30, 0.25), 13),
        ((0.75, -0.35, 2.6), (0.40, 0.35, 0.30), 16),
        ((0.1, 0.85, 3.2), (0.55, 0.25, 0.25), 19),
    ]
    for (cx, cy, cz), (ex, ey, ez), seed in boxes:
        out.append(_plane([cx, cy, cz - ez], [0, 0, -1],
                          [1, 0, 0], [0, 1, 0], ex, ey, seed))
        out.append(_plane([cx, cy - ey, cz], [0, -1, 0],
                          [1, 0, 0], [0, 0, 1], ex, ez, seed + 1))
        out.append(_plane([cx - ex, cy, cz], [-1, 0, 0],
                          [0, 0, 1], [0, 1, 0], ez, ey, seed + 2))
    return out


def _primitive_spheres():
    """(center, radius, seed): curved occluders."""
    return [
        (np.array([0.0, -0.55, 2.1], np.float32), np.float32(0.38), 23),
        (np.array([-1.15, -0.15, 3.0], np.float32), np.float32(0.45), 27),
    ]


def _value_noise_octave(u, v, table):
    """Smoothstep-interpolated value noise from a random grid."""
    S = table.shape[0]
    u = torch.clamp(u, 0.0, S - 1.001)
    v = torch.clamp(v, 0.0, S - 1.001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    fu = u - u0
    fv = v - v0
    fu = fu * fu * (3.0 - 2.0 * fu)
    fv = fv * fv * (3.0 - 2.0 * fv)
    i00 = table[v0, u0]
    i01 = table[v0, u0 + 1]
    i10 = table[v0 + 1, u0]
    i11 = table[v0 + 1, u0 + 1]
    return ((i00 * (1 - fu) + i01 * fu) * (1 - fv)
            + (i10 * (1 - fu) + i11 * fu) * fv)


def _texture(tu, tv, seed: int, eu: float, ev: float):
    """Procedural grayscale texture in [20, 235]: multi-octave value
    noise."""
    rng = np.random.default_rng(seed)
    val = torch.zeros_like(tu)
    total = 0.0
    for size, amp in ((12, 1.0), (48, 0.65), (192, 0.45)):
        table = torch.from_numpy(
            rng.uniform(-1.0, 1.0, (size, size)).astype(np.float32)).to(
                tu.device)
        u = (_div(tu, eu) * 0.5 + 0.5) * (size - 1)
        v = (_div(tv, ev) * 0.5 + 0.5) * (size - 1)
        val = val + amp * _value_noise_octave(u, v, table)
        total += amp
    val = _div(val, total)
    return torch.clamp(val * 0.5 + 0.5, 0.0, 1.0) * 215.0 + 20.0


def _dot(a, b):
    """Over the last axis of 3, term by term (torch.sum's order on the
    CPU, on every device)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _div(a, b: float):
    """a / b for a constant b, as a true division on every device."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def render_frame(cam: Pinhole, pose_q, pose_t, scene: str = "room"):
    """Render (gray [H,W] f32 in [0,255], depth [H,W] f32) for pose T_wc,
    on the device of `pose_q`."""
    dev = pose_q.device
    H, W = cam.height, cam.width
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    # cam.ray, with true divisions.
    rays = torch.stack([_div(u - cam.cx, cam.fx), _div(v - cam.cy, cam.fy),
                        torch.ones_like(u)], dim=-1)
    T = SE3(pose_q, pose_t)
    d_w = T.rotate(rays)
    o_w = pose_t

    def t(x):
        return torch.as_tensor(x, device=dev)

    best_depth = torch.full((H, W), float("inf"), device=dev)
    best_val = torch.zeros((H, W), device=dev)
    planes = _room_planes() if scene == "room" else _primitive_planes()
    for (p0, n, tu_ax, tv_ax, eu, ev, seed) in planes:
        p0, n = t(p0), t(n)
        denom = _dot(d_w, n)
        s = _dot(p0 - o_w, n) / torch.where(
            torch.abs(denom) < 1e-9, float("inf"), denom)
        hit_w = o_w + s[..., None] * d_w
        rel = hit_w - p0
        tu = _dot(rel, t(tu_ax))
        tv = _dot(rel, t(tv_ax))
        inside = (torch.abs(tu) <= eu) & (torch.abs(tv) <= ev) & (s > 0.05)
        depth = torch.where(inside, s, float("inf"))
        closer = depth < best_depth
        best_val = torch.where(closer, _texture(tu, tv, seed, float(eu),
                                                float(ev)), best_val)
        best_depth = torch.minimum(best_depth, depth)

    if scene == "primitives":
        # In float64, rounded to float32 at the end (module docstring).
        f64 = torch.float64
        d64, o64 = d_w.to(f64), o_w.to(f64)
        for (c, r, seed) in _primitive_spheres():
            c = t(c).to(f64)
            r = float(r)
            oc = o64 - c
            a = _dot(d64, d64)
            b = 2.0 * _dot(d64, oc)
            c0 = _dot(oc, oc) - r * r
            disc = b * b - 4.0 * a * c0
            s = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
            hit = (disc > 0.0) & (s > 0.05)
            depth_s = torch.where(hit, s, float("inf")).to(torch.float32)
            closer = depth_s < best_depth
            p = o64 + s[..., None] * d64 - c
            lon = torch.atan2(p[..., 1], p[..., 0]).to(torch.float32)
            lat = torch.asin(torch.clamp(_div(p[..., 2], r), -1.0, 1.0)).to(
                torch.float32)
            tex = _texture(lon, lat, seed, np.pi, np.pi / 2)
            best_val = torch.where(closer, tex, best_val)
            best_depth = torch.minimum(best_depth, depth_s)
    elif scene != "room":
        raise ValueError(f"unknown scene {scene!r}")

    finite = torch.isfinite(best_depth)
    gray = torch.where(finite, best_val, torch.zeros_like(best_val))
    depth = torch.where(finite, best_depth, torch.zeros_like(best_depth))
    return gray, depth


def make_trajectory(n_frames: int, motion: str = "strafe",
                    device=None) -> SE3:
    """Smooth camera trajectory, camera-to-world, RDF world, made on the
    host and placed on `device` (the same poses on every device)."""
    ts = np.linspace(0.0, 1.0, n_frames, dtype=np.float32)
    zeros = np.zeros_like(ts)
    if motion == "strafe":
        tx = 0.6 * np.sin(2 * np.pi * ts)
        ty = 0.18 * (1.0 - np.cos(2 * np.pi * ts))
        tz = 0.15 * ts
        yaw = 0.05 * np.sin(2 * np.pi * ts)
        taus = np.stack([tx, ty, tz, zeros, yaw, zeros], axis=-1)
    elif motion == "forward":
        tx = 0.05 * np.sin(2 * np.pi * ts)
        taus = np.stack([tx, zeros, 0.9 * ts, zeros, zeros, zeros], axis=-1)
    elif motion == "rotation":
        tx = 0.06 * np.sin(2 * np.pi * ts)
        ty = 0.02 * (1.0 - np.cos(2 * np.pi * ts))
        yaw = 0.30 * np.sin(2 * np.pi * ts)
        pitch = 0.06 * np.sin(4 * np.pi * ts)
        taus = np.stack([tx, ty, zeros, pitch, yaw, zeros], axis=-1)
    elif motion == "mav":
        tx = 0.5 * np.sin(2 * np.pi * ts)
        ty = 0.15 * np.sin(4 * np.pi * ts + 0.7)
        tz = 0.45 * (1.0 - np.cos(2 * np.pi * ts))
        roll = 0.15 * np.sin(4 * np.pi * ts)
        pitch = 0.12 * np.sin(4 * np.pi * ts + 1.1)
        yaw = 0.25 * np.sin(2 * np.pi * ts + 0.4)
        taus = np.stack([tx, ty, tz, pitch, yaw, roll], axis=-1)
    elif motion == "static":
        taus = np.zeros((n_frames, 6), np.float32)
    else:
        raise ValueError(f"unknown motion {motion}")
    poses = SE3.exp(taus.astype(np.float32))
    if device is None:
        return poses
    return SE3(poses.q.to(device), poses.t.to(device))


@dataclass
class SyntheticSequence:
    cam: Pinhole
    images: torch.Tensor      # [N, H, W] float32, grayscale 0..255
    depths: torch.Tensor      # [N, H, W] float32 meters (0 where invalid)
    poses: SE3                # batched [N]
    timestamps: np.ndarray    # [N] seconds

    def __len__(self):
        return self.images.shape[0]


def _host_arrays(seq: "SyntheticSequence"):
    """(images, depths, q, t) of a sequence as host numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in
                 (seq.images, seq.depths, seq.poses.q, seq.poses.t))


def export_asl(seq: "SyntheticSequence", root: str,
               depth_scale: float = 5000.0) -> None:
    """Write a sequence as a EuRoC/ASL folder tree (mav0-style: cam0 +
    depth0 + state_groundtruth_estimate0, sensor.yaml + data.csv + PNG
    data folders), so that the whole ASL route (folder reader, timestamp
    association, T_BS chain, world-frame conversion, rectification) runs
    end to end on exact-GT data. The files equal the JAX package's
    `export_asl` for the same frames. Poses are camera-to-world RDF with
    identity T_BS (load with world_frame="RDF"); depth is uint16 at
    1/depth_scale m (truncated), poses printed to 9 decimals."""
    import os

    import cv2
    import yaml

    cam = seq.cam
    cam0 = os.path.join(root, "cam0")
    depth0 = os.path.join(root, "depth0")
    pose0 = os.path.join(root, "state_groundtruth_estimate0")
    for d in (cam0, depth0):
        os.makedirs(os.path.join(d, "data"), exist_ok=True)
    os.makedirs(pose0, exist_ok=True)
    yaml_T = {"rows": 4, "cols": 4, "data": np.eye(4).ravel().tolist()}
    with open(os.path.join(cam0, "sensor.yaml"), "w") as f:
        yaml.dump({"sensor_type": "camera", "T_BS": yaml_T,
                   "intrinsics": [cam.fx, cam.fy, cam.cx, cam.cy],
                   "resolution": [cam.width, cam.height],
                   "distortion_coefficients": [0.0, 0.0, 0.0, 0.0]}, f)
    with open(os.path.join(depth0, "sensor.yaml"), "w") as f:
        yaml.dump({"sensor_type": "depth", "T_BS": yaml_T,
                   "depth_scale_factor": float(depth_scale)}, f)
    with open(os.path.join(pose0, "sensor.yaml"), "w") as f:
        yaml.dump({"sensor_type": "visual-inertial", "T_BS": yaml_T}, f)
    images, depths, q, t = _host_arrays(seq)
    cam_rows, depth_rows, pose_rows = [], [], []
    for i in range(len(seq)):
        ts = int(round(float(seq.timestamps[i]) * 1e9))
        cv2.imwrite(os.path.join(cam0, "data", f"{ts}.png"),
                    np.clip(images[i], 0, 255).astype(np.uint8))
        d16 = np.clip(depths[i] * depth_scale, 0, 65535)
        cv2.imwrite(os.path.join(depth0, "data", f"{ts}.png"),
                    d16.astype(np.uint16))
        cam_rows.append(f"{ts},{ts}.png")
        depth_rows.append(f"{ts},{ts}.png")
        pose_rows.append(
            f"{ts},{float(t[i, 0]):.9f},{float(t[i, 1]):.9f},"
            f"{float(t[i, 2]):.9f},{float(q[i, 0]):.9f},"
            f"{float(q[i, 1]):.9f},{float(q[i, 2]):.9f},"
            f"{float(q[i, 3]):.9f}")
    hdr = "#timestamp [ns],filename\n"
    with open(os.path.join(cam0, "data.csv"), "w") as f:
        f.write(hdr + "\n".join(cam_rows) + "\n")
    with open(os.path.join(depth0, "data.csv"), "w") as f:
        f.write(hdr + "\n".join(depth_rows) + "\n")
    with open(os.path.join(pose0, "data.csv"), "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n"
                + "\n".join(pose_rows) + "\n")


def export_tum(seq: "SyntheticSequence", root: str,
               depth_scale: float = 5000.0) -> tuple:
    """Write a sequence as a TUM RGB-D tree (rgb/ + depth/ PNG folders, a
    pre-associated assoc.txt in the reference's pose-rgb-depth line
    format and a ROS CameraInfo calib.yaml), so that the whole TUM route
    (association parser, P-matrix calibration, rectification, uint16
    depth scaling, frame conversion) runs end to end on exact-GT data.
    The files equal the JAX package's `export_tum` for the same frames.
    Poses are camera-to-world RDF (load with --input-frame RDF), the
    quaternions in TUM xyzw order. Returns (assoc_path, calib_path)."""
    import os

    import cv2

    cam = seq.cam
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    images, depths, q, t = _host_arrays(seq)     # q: (w, x, y, z)
    lines = []
    for i in range(len(seq)):
        ts = float(seq.timestamps[i])
        name = f"{ts:.6f}.png"
        cv2.imwrite(os.path.join(root, "rgb", name),
                    np.clip(images[i], 0, 255).astype(np.uint8))
        d16 = np.clip(depths[i] * depth_scale, 0, 65535)
        cv2.imwrite(os.path.join(root, "depth", name),
                    d16.astype(np.uint16))
        lines.append(
            f"{ts:.6f} {t[i, 0]:.9f} {t[i, 1]:.9f} {t[i, 2]:.9f} "
            f"{q[i, 1]:.9f} {q[i, 2]:.9f} {q[i, 3]:.9f} {q[i, 0]:.9f} "
            f"{ts:.6f} rgb/{name} {ts:.6f} depth/{name}")
    assoc = os.path.join(root, "assoc.txt")
    with open(assoc, "w") as f:
        f.write("\n".join(lines) + "\n")
    calib = os.path.join(root, "calib.yaml")
    K = [cam.fx, 0.0, cam.cx, 0.0, cam.fy, cam.cy, 0.0, 0.0, 1.0]
    P = [cam.fx, 0.0, cam.cx, 0.0,
         0.0, cam.fy, cam.cy, 0.0,
         0.0, 0.0, 1.0, 0.0]
    with open(calib, "w") as f:
        f.write(
            f"image_width: {cam.width}\n"
            f"image_height: {cam.height}\n"
            "camera_name: synthetic\n"
            "camera_matrix: {rows: 3, cols: 3, data: "
            f"{K}}}\n"
            "distortion_model: plumb_bob\n"
            "distortion_coefficients: {rows: 1, cols: 5, "
            "data: [0, 0, 0, 0, 0]}\n"
            "projection_matrix: {rows: 3, cols: 4, data: "
            f"{P}}}\n")
    return assoc, calib


def make_sequence(n_frames: int = 30, cam: Pinhole = QVGA,
                  motion: str = "strafe", fps: float = 30.0,
                  texture_gain: float = 1.0,
                  exposure_amp: float = 0.0,
                  exposure_period: float = 50.0,
                  scene: str = "room", device=None) -> SyntheticSequence:
    """Render a posed sequence on `device` (the card unless the caller
    asks for another device). GT depths and poses are exact in every
    regime. Stress knobs, applied on the device in the JAX package's
    order (contrast, then exposure, then the clip to [0, 255]):

    - texture_gain: scales image contrast about mid-gray (1.0 = normal;
      0.3 leaves ~7% of VGA pixels above the detector's gradient floor);
    - exposure_amp r: per-frame affine brightness oscillation, gain
      1 + r*sin(2*pi*i/period) and bias 30*r*sin(2*pi*i/period + 1.3)
      (auto-exposure "hunting"; engine.zero_mean_ssd is the counter).
    """
    return make_sequences(n_frames, cam, [(texture_gain, exposure_amp)],
                          motion=motion, fps=fps,
                          exposure_period=exposure_period, scene=scene,
                          device=device)[0]


def make_sequences(n_frames: int, cam: Pinhole, knobs, motion: str = "strafe",
                   fps: float = 30.0, exposure_period: float = 50.0,
                   scene: str = "room", device=None):
    """make_sequence for each (texture_gain, exposure_amp) of knobs, over
    one rendering of the scene: the sequences share their depths and
    poses, and each equals make_sequence's with those knobs."""
    dev = resolve_device(device)
    poses = make_trajectory(n_frames, motion, device=dev)
    imgs, deps = [[] for _ in knobs], []
    for i in range(n_frames):
        g0, d = render_frame(cam, poses.q[i], poses.t[i], scene)
        for out, (texture_gain, exposure_amp) in zip(imgs, knobs):
            g = g0
            if texture_gain != 1.0:
                g = 127.5 + texture_gain * (g - 127.5)
            if exposure_amp != 0.0:
                ph = 2.0 * np.pi * i / exposure_period
                gain = float(1.0 + exposure_amp * np.sin(ph))
                bias = float(30.0 * exposure_amp * np.sin(ph + 1.3))
                # In float64, as the JAX package's numpy does (its gain
                # and bias are float64 scalars); rounded to float32 after
                # the clip.
                g = gain * g.to(torch.float64) + bias
            out.append(torch.clamp(g, 0.0, 255.0).to(torch.float32))
        deps.append(d)
    depths = torch.stack(deps)
    stamps = np.arange(n_frames, dtype=np.float64) / fps
    return [SyntheticSequence(cam=cam, images=torch.stack(x), depths=depths,
                              poses=poses, timestamps=stamps) for x in imgs]
