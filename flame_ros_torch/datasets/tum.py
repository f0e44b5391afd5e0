"""TUM RGB-D dataset loading.

A copy of `flame_ros_tpu/datasets/tum.py` (host numpy; images read with
cv2, imported where an image is read).

Capability parity with TUMRGBDOfflineStream (reference:
src/ros_sensor_streams/tum_rgbd_offline_stream.{h,cc}): consumes the
pre-associated input file format
    pose_time tx ty tz qx qy qz qw rgb_time rgb_file [depth_time depth_file]
(parseLine, cc:248-300), loads images relative to the file's directory,
rectifies with plumb-bob distortion from a ROS CameraInfo YAML calibration
(cc:197-200; K is taken from the P matrix like the reference, cc:96-103),
scales 16-bit depth to meters by depth_scale_factor (default 5000,
cc:203-208), and normalizes poses from any supported input frame to RDF
optical coordinates (cc:146-194).

Also ships the association tool the TUM benchmark provides out-of-repo:
`build_associations` joins groundtruth.txt/rgb.txt/depth.txt into the
consumed format so raw TUM sequence folders work directly.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import yaml

from flame_ros_torch.datasets.associate import associate
from flame_ros_torch.geometry.camera import (Pinhole, remap_bilinear,
                                             undistort_maps)
from flame_ros_torch.geometry.frames import TUM_FRAMES, to_rdf


@dataclass
class CameraCalib:
    cam: Pinhole
    dist_coeffs: np.ndarray  # plumb-bob (k1 k2 p1 p2 k3); zeros = none
    raw_K: np.ndarray        # pre-rectification camera matrix


def load_camera_info_yaml(path: str) -> CameraCalib:
    """ROS CameraInfo YAML (reference loads via camera_info_manager,
    tum_rgbd_offline_stream.cc:87-103; K comes from the P matrix)."""
    with open(path) as f:
        d = yaml.safe_load(f)
    w = int(d["image_width"])
    h = int(d["image_height"])
    P = np.asarray(d["projection_matrix"]["data"], np.float64).reshape(3, 4)
    K_raw = np.asarray(d["camera_matrix"]["data"], np.float64).reshape(3, 3)
    dist = np.asarray(d.get("distortion_coefficients", {}).get("data", []),
                      np.float64)
    cam = Pinhole(fx=float(P[0, 0]), fy=float(P[1, 1]),
                  cx=float(P[0, 2]), cy=float(P[1, 2]), width=w, height=h)
    return CameraCalib(cam=cam, dist_coeffs=dist, raw_K=K_raw)


# TUM benchmark default intrinsics (freiburg3 sequences are pre-rectified).
TUM_FR1 = Pinhole(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
TUM_FR2 = Pinhole(fx=520.9, fy=521.0, cx=325.1, cy=249.7, width=640, height=480)
TUM_FR3 = Pinhole(fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640, height=480)


@dataclass
class TUMFrame:
    img_id: int
    time: float
    rgb: np.ndarray          # [H, W, 3] uint8
    gray: np.ndarray         # [H, W] float32 0..255
    depth: np.ndarray        # [H, W] float32 meters (0 invalid)
    quat: np.ndarray         # (w, x, y, z), camera-to-world, RDF
    trans: np.ndarray        # (3,)


def _read_lines(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]


def build_associations(seq_dir: str, out_path: Optional[str] = None,
                       max_diff: float = 0.02) -> list[str]:
    """Join a raw TUM folder (rgb.txt, depth.txt, groundtruth.txt) into the
    consumed association format."""
    def parse_list(name, ncols):
        rows = []
        for ln in _read_lines(os.path.join(seq_dir, name)):
            parts = ln.split()
            rows.append((float(parts[0]), parts[1:]))
        return rows

    rgb = parse_list("rgb.txt", 2)
    gt = parse_list("groundtruth.txt", 8)
    t_rgb = np.array([r[0] for r in rgb])
    t_gt = np.array([g[0] for g in gt])
    ia, ib = associate(t_rgb, t_gt, max_diff)
    lines = []
    depth = None
    if os.path.exists(os.path.join(seq_dir, "depth.txt")):
        depth = parse_list("depth.txt", 2)
        t_d = np.array([d[0] for d in depth])
    for a, b in zip(ia, ib):
        pose = gt[b][1]
        line = (f"{t_gt[b]:.6f} " + " ".join(pose[:7])
                + f" {t_rgb[a]:.6f} {rgb[a][1][0]}")
        if depth is not None:
            ja, jb = associate(np.array([t_rgb[a]]), t_d, max_diff)
            if len(jb):
                line += f" {t_d[jb[0]]:.6f} {depth[jb[0]][1][0]}"
        lines.append(line)
    if out_path:
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return lines


class TUMRGBDStream:
    """Pull-based offline stream (reference get()/empty() protocol)."""

    def __init__(self, input_file: str,
                 calib: Optional[CameraCalib | Pinhole] = None,
                 input_frame: str = "RDF",
                 depth_scale_factor: float = 5000.0,
                 resize_factor: int = 1):
        if input_frame not in TUM_FRAMES:
            raise ValueError(f"input_frame must be one of {TUM_FRAMES}")
        self.base_dir = os.path.dirname(os.path.abspath(input_file))
        self.lines = _read_lines(input_file)
        self.input_frame = input_frame
        self.depth_scale = depth_scale_factor
        self.resize_factor = resize_factor
        self._idx = 0
        if isinstance(calib, Pinhole):
            calib = CameraCalib(cam=calib, dist_coeffs=np.zeros(0),
                                raw_K=calib.K.astype(np.float64))
        self.calib = calib
        self._maps = None
        self._cam: Optional[Pinhole] = None

    @property
    def cam(self) -> Pinhole:
        if self._cam is None:
            # Peek the first image for dimensions if no calib given.
            if self.calib is None:
                frame = self._parse(self.lines[0], 0, raw=True)
                h, w = frame.rgb.shape[:2]
                self.calib = CameraCalib(
                    cam=Pinhole(TUM_FR3.fx, TUM_FR3.fy, TUM_FR3.cx,
                                TUM_FR3.cy, w, h),
                    dist_coeffs=np.zeros(0), raw_K=TUM_FR3.K.astype(np.float64))
            cam = self.calib.cam
            if self.resize_factor != 1:
                cam = cam.scaled(self.resize_factor)
            self._cam = cam
        return self._cam

    def __len__(self):
        return len(self.lines)

    def empty(self) -> bool:
        return self._idx >= len(self.lines)

    def _load_img(self, rel: str) -> np.ndarray:
        import cv2
        img = cv2.imread(os.path.join(self.base_dir, rel),
                         cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(os.path.join(self.base_dir, rel))
        return img

    def _rectify(self, img: np.ndarray) -> np.ndarray:
        if self.calib is None or self.calib.dist_coeffs.size == 0 or \
                not np.any(self.calib.dist_coeffs):
            return img
        if self._maps is None:
            self._maps = undistort_maps(self.calib.cam,
                                        self.calib.dist_coeffs,
                                        raw_K=self.calib.raw_K)
        return remap_bilinear(img, *self._maps)

    def _parse(self, line: str, img_id: int, raw: bool = False) -> TUMFrame:
        parts = line.split()
        pose_time = float(parts[0])
        tx, ty, tz = (float(x) for x in parts[1:4])
        qx, qy, qz, qw = (float(x) for x in parts[4:8])
        rgb_time = float(parts[8])
        rgb = self._load_img(parts[9])
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, -1)
        elif rgb.shape[2] == 4:
            rgb = rgb[:, :, :3]
        rgb = rgb[:, :, ::-1]  # BGR (cv2) -> RGB
        if len(parts) >= 12:
            depth_raw = self._load_img(parts[11]).astype(np.float32)
            depth = depth_raw / self.depth_scale
        else:
            depth = np.zeros(rgb.shape[:2], np.float32)
        if raw:
            return TUMFrame(img_id, rgb_time, rgb, None, depth, None, None)

        rgb = self._rectify(rgb)
        depth = self._rectify(depth)
        if self.resize_factor != 1:
            import cv2
            cam = self.cam
            rgb = cv2.resize(rgb, (cam.width, cam.height),
                             interpolation=cv2.INTER_AREA)
            depth = cv2.resize(depth, (cam.width, cam.height),
                               interpolation=cv2.INTER_NEAREST)
        gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                + 0.114 * rgb[..., 2]).astype(np.float32)
        quat, trans = to_rdf(np.array([qw, qx, qy, qz]),
                             np.array([tx, ty, tz]), self.input_frame)
        return TUMFrame(img_id=img_id, time=rgb_time, rgb=rgb, gray=gray,
                        depth=depth.astype(np.float32),
                        quat=quat.astype(np.float32),
                        trans=trans.astype(np.float32))

    def get(self) -> TUMFrame:
        frame = self._parse(self.lines[self._idx], self._idx)
        self._idx += 1
        return frame

    def __iter__(self) -> Iterator[TUMFrame]:
        while not self.empty():
            yield self.get()
