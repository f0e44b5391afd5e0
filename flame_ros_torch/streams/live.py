"""Live tracked-image stream: posed-frame ingest for online operation.

Counterpart of `flame_ros_tpu/streams/live.py` (host code; poses are the
port's SE3 of CPU tensors).

Capability parity with ros_sensor_streams::TrackedImageStream (reference:
src/ros_sensor_streams/tracked_image_stream.{h,cc}): images arrive from a
capture callback, the camera pose is resolved per frame from a
time-indexed pose buffer (the tf-tree equivalent: tf_buffer_.lookupTransform
at the image stamp, cc:179-181 — lookup failure drops the frame,
cc:182-185), optional undistortion/resize (second ctor, cc:68-113), and
the posed frame is pushed into a bounded drop-newest queue.
"""
from __future__ import annotations

import bisect
import threading
from typing import Callable, Optional

import numpy as np

from flame_ros_torch.geometry.camera import (Pinhole, remap_bilinear,
                                             undistort_maps)
from flame_ros_torch.geometry.se3 import SE3
from flame_ros_torch.streams.queue import ThreadSafeQueue


class PoseTable:
    """Time-indexed pose buffer with interpolation (the tf tree's role).

    Poses are camera(or body)-to-world, RDF. `lookup` linearly
    interpolates translation and nlerps rotation between bracketing
    samples; queries outside the buffered range fail (None), matching tf
    extrapolation failures.
    """

    def __init__(self, maxlen: int = 1024):
        self._times: list[float] = []
        self._qs: list[np.ndarray] = []
        self._ts: list[np.ndarray] = []
        self._maxlen = maxlen
        self._lock = threading.Lock()

    def add(self, time: float, quat_wxyz, trans):
        with self._lock:
            i = bisect.bisect(self._times, time)
            self._times.insert(i, float(time))
            self._qs.insert(i, np.asarray(quat_wxyz, np.float64))
            self._ts.insert(i, np.asarray(trans, np.float64))
            if len(self._times) > self._maxlen:
                self._times.pop(0)
                self._qs.pop(0)
                self._ts.pop(0)

    def lookup(self, time: float,
               max_extrapolation: float = 0.0) -> Optional[SE3]:
        with self._lock:
            if not self._times:
                return None
            i = bisect.bisect(self._times, time)
            if i == 0:
                if self._times[0] - time > max_extrapolation:
                    return None
                return SE3.from_quat_trans(self._qs[0], self._ts[0])
            if i == len(self._times):
                if time - self._times[-1] > max_extrapolation:
                    return None
                return SE3.from_quat_trans(self._qs[-1], self._ts[-1])
            t0, t1 = self._times[i - 1], self._times[i]
            a = (time - t0) / max(t1 - t0, 1e-12)
            q0, q1 = self._qs[i - 1], self._qs[i]
            if np.dot(q0, q1) < 0:
                q1 = -q1
            q = (1 - a) * q0 + a * q1  # nlerp
            q = q / np.linalg.norm(q)
            t = (1 - a) * self._ts[i - 1] + a * self._ts[i]
            return SE3.from_quat_trans(q, t)


class TrackedImageStream:
    """Joins an image callback with the pose table; emits posed frames.

    sink: callable(img_id, time, quat, trans, gray, depth) — typically
    FlameNodelet.push_frame. Frames without a resolvable pose are dropped
    and counted (reference behavior).
    """

    def __init__(self, cam: Pinhole, poses: PoseTable,
                 sink: Callable, *, dist_coeffs=None,
                 resize_factor: int = 1, queue_size: int = 8):
        self.raw_cam = cam
        self.poses = poses
        self.sink = sink
        self.resize_factor = resize_factor
        self._maps = None
        if dist_coeffs is not None and np.any(np.asarray(dist_coeffs)):
            self._maps = undistort_maps(cam, dist_coeffs)
        self.cam = cam.scaled(resize_factor) if resize_factor != 1 else cam
        self.num_pose_failures = 0
        self._next_id = 0
        # Bounded handoff mirroring the nodelet-internal queue semantics.
        self.queue: ThreadSafeQueue = ThreadSafeQueue(queue_size)

    def image_callback(self, time: float, img: np.ndarray,
                       depth: Optional[np.ndarray] = None) -> bool:
        """Capture callback: resolve pose, normalize image, forward."""
        pose = self.poses.lookup(time)
        if pose is None:
            self.num_pose_failures += 1
            return False
        gray = np.asarray(img, np.float32)
        if gray.ndim == 3:
            gray = (0.299 * gray[..., 0] + 0.587 * gray[..., 1]
                    + 0.114 * gray[..., 2])
        if self._maps is not None:
            gray = remap_bilinear(gray, *self._maps)
            if depth is not None:
                depth = remap_bilinear(depth, *self._maps)
        if self.resize_factor != 1:
            import cv2
            gray = cv2.resize(gray, (self.cam.width, self.cam.height),
                              interpolation=cv2.INTER_AREA)
            if depth is not None:
                depth = cv2.resize(depth, (self.cam.width, self.cam.height),
                                   interpolation=cv2.INTER_NEAREST)
        img_id = self._next_id
        self._next_id += 1
        return self.sink(img_id, time, np.asarray(pose.q),
                         np.asarray(pose.t), gray, depth)
