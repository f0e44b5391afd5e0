"""EuRoC / ASL dataset loading.

A copy of `flame_ros_tpu/datasets/asl.py` (host numpy; images read with
cv2, imported where an image is read).

Capability parity with the reference's ASL stack (dataset_utils::asl::
Dataset generic YAML+CSV folder reader, src/dataset_utils/asl/dataset.h;
record types types.h; ASLRGBDOfflineStream src/ros_sensor_streams/
asl_rgbd_offline_stream.{h,cc}): reads sensor folders of the form

    <folder>/sensor.yaml   (metadata incl. T_BS extrinsic, intrinsics)
    <folder>/data.csv      (timestamped records)
    <folder>/data/         (image files for camera sensors)

associates RGB (and optional depth) frames to the nearest pose within
0.02 s (cc:152-203), composes the pose chain
T_world_cam = T_world_posesensor ∘ T_BS(pose)^-1 ∘ T_BS(cam)
(cc:205-232: pose sensor in body, camera in body), converts the world
frame to RDF (cc:235-275), and rectifies radtan distortion.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import yaml

from flame_ros_torch.datasets.associate import associate
from flame_ros_torch.geometry.camera import (Pinhole, remap_bilinear,
                                             undistort_maps)
from flame_ros_torch.geometry.frames import ASL_FRAMES, world_to_rdf


@dataclass
class IMUData:
    """ASL IMU record (reference dataset_utils::asl::IMUData, types.h:37)."""
    timestamp: int
    gyro: np.ndarray    # [3] rad/s
    accel: np.ndarray   # [3] m/s^2

    @staticmethod
    def from_row(ts: int, row: list) -> "IMUData":
        v = [float(x) for x in row]
        return IMUData(ts, np.asarray(v[0:3]), np.asarray(v[3:6]))


@dataclass
class PoseData:
    """ASL pose record: p [3] + q (w,x,y,z) (reference types.h:60)."""
    timestamp: int
    trans: np.ndarray
    quat: np.ndarray

    @staticmethod
    def from_row(ts: int, row: list) -> "PoseData":
        v = [float(x) for x in row]
        q = np.asarray(v[3:7])
        return PoseData(ts, np.asarray(v[0:3]), q / np.linalg.norm(q))


@dataclass
class PositionData:
    """ASL position-only record (e.g. Leica, reference types.h:83)."""
    timestamp: int
    pos: np.ndarray

    @staticmethod
    def from_row(ts: int, row: list) -> "PositionData":
        return PositionData(ts, np.asarray([float(x) for x in row[0:3]]))


@dataclass
class FileData:
    """ASL file record: timestamped filename (reference types.h:104)."""
    timestamp: int
    filename: str

    @staticmethod
    def from_row(ts: int, row: list) -> "FileData":
        return FileData(ts, row[0])


@dataclass
class ASLSensor:
    """Generic ASL sensor folder (reference Dataset<Data>)."""
    path: str
    metadata: dict = field(default_factory=dict)
    timestamps: np.ndarray = None        # [N] int64 nanoseconds
    records: list = None                 # raw CSV rows (str lists)

    @staticmethod
    def read(path: str) -> "ASLSensor":
        with open(os.path.join(path, "sensor.yaml")) as f:
            meta = yaml.safe_load(f)
        ts = []
        rows = []
        csv_path = os.path.join(path, "data.csv")
        if os.path.exists(csv_path):
            with open(csv_path) as f:
                for row in csv.reader(f):
                    if not row or row[0].startswith("#"):
                        continue
                    ts.append(int(row[0]))
                    rows.append([c.strip() for c in row[1:]])
        return ASLSensor(path=path, metadata=meta,
                         timestamps=np.asarray(ts, np.int64), records=rows)

    def T_BS(self) -> tuple[np.ndarray, np.ndarray]:
        """(R [3,3], t [3]) sensor-in-body extrinsic."""
        data = self.metadata["T_BS"]["data"]
        T = np.asarray(data, np.float64).reshape(4, 4)
        return T[:3, :3], T[:3, 3]

    def typed_records(self):
        """Parse CSV rows into typed records by sensor_type (reference
        Dataset<Data> with IMUData/PoseData/PositionData/FileData)."""
        kind = self.metadata.get("sensor_type", "")
        cls = {"imu": IMUData, "camera": FileData,
               "visual-inertial": PoseData, "vicon": PoseData,
               "position": PositionData}.get(kind)
        if cls is None:
            # Heuristic on column count.
            ncols = len(self.records[0]) if self.records else 0
            cls = {1: FileData, 3: PositionData, 6: IMUData,
                   7: PoseData}.get(ncols, FileData)
        return [cls.from_row(int(ts), row)
                for ts, row in zip(self.timestamps, self.records)]


@dataclass
class ASLFrame:
    img_id: int
    time: float
    rgb: np.ndarray
    gray: np.ndarray
    depth: np.ndarray
    quat: np.ndarray   # camera-to-world (RDF), (w,x,y,z)
    trans: np.ndarray


def _quat_from_R(R):
    w = 0.5 * np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12))
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                     (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw])


def _qrot(q, v):
    qv = q[1:]
    uv = 2.0 * np.cross(qv, v)
    return v + q[0] * uv + np.cross(qv, uv)


def _qconj(q):
    return q * np.array([1.0, -1, -1, -1])


class ASLRGBDStream:
    """EuRoC/ASL offline stream (reference ASLRGBDOfflineStream)."""

    def __init__(self, pose_path: str, rgb_path: str,
                 depth_path: Optional[str] = None,
                 world_frame: str = "RDF", max_diff: float = 0.02,
                 resize_factor: int = 1):
        if world_frame not in ASL_FRAMES:
            raise ValueError(f"world_frame must be one of {ASL_FRAMES}")
        self.world_frame = world_frame
        self.pose = ASLSensor.read(pose_path)
        self.rgb = ASLSensor.read(rgb_path)
        self.depth = ASLSensor.read(depth_path) if depth_path else None
        self.resize_factor = resize_factor

        # Camera intrinsics from sensor.yaml (cc:95-122).
        intr = self.rgb.metadata["intrinsics"]
        res = self.rgb.metadata.get("resolution", [752, 480])
        self._raw_cam = Pinhole(fx=float(intr[0]), fy=float(intr[1]),
                                cx=float(intr[2]), cy=float(intr[3]),
                                width=int(res[0]), height=int(res[1]))
        dist = self.rgb.metadata.get("distortion_coefficients", [])
        self.dist = np.asarray(list(dist) + [0.0] * (5 - len(dist)))
        self._maps = None
        self._cam = None

        self.depth_scale = 1.0
        if self.depth is not None:
            self.depth_scale = float(
                self.depth.metadata.get("depth_scale_factor", 1.0))

        # Extrinsics (cc:137-147).
        Rp, tp = self.pose.T_BS()
        Rc, tc = self.rgb.T_BS()
        self.q_pose_in_body = _quat_from_R(Rp)
        self.t_pose_in_body = tp
        self.q_cam_in_body = _quat_from_R(Rc)
        self.t_cam_in_body = tc

        # Associate rgb (and depth) to poses (cc:152-203).
        t_rgb = self.rgb.timestamps * 1e-9
        t_pose = self.pose.timestamps * 1e-9
        ia, ib = associate(t_rgb, t_pose, max_diff)
        self.rgb_idxs = ia
        self.pose_idxs = ib
        self.depth_idxs = None
        if self.depth is not None:
            t_d = self.depth.timestamps * 1e-9
            ja, jb = associate(t_rgb[ia], t_d, max_diff)
            # Keep only rgb frames that also have depth.
            self.rgb_idxs = ia[ja]
            self.pose_idxs = ib[ja]
            self.depth_idxs = jb
        self._idx = 0

    @property
    def cam(self) -> Pinhole:
        if self._cam is None:
            cam = self._raw_cam
            if self.resize_factor != 1:
                cam = cam.scaled(self.resize_factor)
            self._cam = cam
        return self._cam

    def __len__(self):
        return len(self.rgb_idxs)

    def empty(self) -> bool:
        return self._idx >= len(self.rgb_idxs)

    def _pose_record(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Body-in-world pose from a pose-sensor CSV row: supports vicon
        (p, q) and state-estimate layouts (reference PoseData: p[3], q[4])."""
        row = [float(x) for x in self.pose.records[k]]
        t = np.asarray(row[0:3])
        q = np.asarray(row[3:7])  # qw qx qy qz (ASL convention)
        return q / np.linalg.norm(q), t

    def _rectify(self, img):
        if not np.any(self.dist):
            return img
        if self._maps is None:
            self._maps = undistort_maps(self._raw_cam, self.dist)
        return remap_bilinear(img, *self._maps)

    def get(self) -> ASLFrame:
        import cv2
        k = self._idx
        self._idx += 1
        ri = self.rgb_idxs[k]
        pi = self.pose_idxs[k]
        fname = self.rgb.records[ri][0]
        img = cv2.imread(os.path.join(self.rgb.path, "data", fname),
                         cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(fname)
        if img.ndim == 2:
            rgb = np.stack([img] * 3, -1)
        else:
            rgb = img[:, :, :3][:, :, ::-1]
        rgb = self._rectify(rgb)

        if self.depth is not None:
            dname = self.depth.records[self.depth_idxs[k]][0]
            draw = cv2.imread(os.path.join(self.depth.path, "data", dname),
                              cv2.IMREAD_ANYDEPTH)
            depth = self._rectify(draw.astype(np.float32)) / self.depth_scale
        else:
            depth = np.zeros(rgb.shape[:2], np.float32)

        if self.resize_factor != 1:
            cam = self.cam
            rgb = cv2.resize(rgb, (cam.width, cam.height),
                             interpolation=cv2.INTER_AREA)
            depth = cv2.resize(depth, (cam.width, cam.height),
                               interpolation=cv2.INTER_NEAREST)
        gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                + 0.114 * rgb[..., 2]).astype(np.float32)

        # Pose chain (cc:205-232): pose sensor in world -> body in world ->
        # camera in world.
        q_ps_w, t_ps_w = self._pose_record(pi)
        q_body_w = _qmul(q_ps_w, _qconj(self.q_pose_in_body))
        t_body_w = t_ps_w - _qrot(q_body_w, self.t_pose_in_body)
        q_cam_w = _qmul(q_body_w, self.q_cam_in_body)
        t_cam_w = _qrot(q_body_w, self.t_cam_in_body) + t_body_w
        quat, trans = world_to_rdf(q_cam_w, t_cam_w, self.world_frame)

        return ASLFrame(img_id=k,
                        time=float(self.rgb.timestamps[ri]) * 1e-9,
                        rgb=rgb, gray=gray, depth=depth,
                        quat=quat.astype(np.float32),
                        trans=trans.astype(np.float32))

    def __iter__(self) -> Iterator[ASLFrame]:
        while not self.empty():
            yield self.get()
