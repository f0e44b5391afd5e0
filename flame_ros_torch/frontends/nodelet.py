"""Online streaming frontend (the reference FlameNodelet) on torch.

Counterpart of `flame_ros_tpu/frontends/nodelet.py` with external poses
(reference src/flame_nodelet.cc):
- producer/consumer pipeline: ingest pushes posed frames into a bounded
  drop-newest queue; a processing thread consumes them (reference
  std::thread(&FlameNodelet::main), cc:406, queue cap 8,
  thread_safe_queue.h:70-83);
- poseframe scheduling ((id - first_pf_id) % poseframe_subsample_factor
  == 0, cc:632-633) and frame subsampling;
- external pose-graph updates that retro-correct keyframe poses and prune
  poseframes (poseframeCallback, cc:414-479), as a method call;
- the angular-rate gate that suppresses output during fast rotation
  (cc:644-662);
- a health heartbeat, READY/ALARM/FAIL by the time since the last
  successful update (cc:481-505);
- per-frame telemetry: the engine's stats plus fps, queue depth, latency
  and process/system loads (msg/FlameNodeletStats.msg).

ROS topics become callbacks (`on_mesh`, `on_idepth`, `on_stats`,
`on_heartbeat`). Frames may be numpy arrays or tensors (on the engine's
device they stay there). Pose estimation by direct tracking and bundle
adjustment (`pose_source="tracking"`, `ba_refine=True`) are not ported
yet: ROADMAP.md queue 1, items 11 and 12.
"""
from __future__ import annotations

import collections
import enum
import threading
import time as time_mod
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from flame_ros_torch.config import FlameParams
from flame_ros_torch.eval.metrics import has_ground_truth
from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.geometry.se3 import SE3
from flame_ros_torch.models.engine import Flame
from flame_ros_torch.streams.queue import ThreadSafeQueue
from flame_ros_torch.utils.load_tracker import LoadTracker


class Health(enum.Enum):
    """Reference FLA ProcessStatus escalation (flame_nodelet.cc:107-112)."""
    READY = 0
    ALARM = 1
    FAIL = 2


@dataclass
class InputFrame:
    img_id: int
    time: float
    quat: np.ndarray      # (w, x, y, z) camera-to-world RDF
    trans: np.ndarray
    gray: object          # [H, W] numpy array or tensor
    depth: Optional[object] = None
    recv_time: float = field(default_factory=time_mod.perf_counter)


class FlameNodelet:
    """pose_source "external": frames arrive with poses (the reference's
    tf lookups, or a dataset's ground truth). The engine runs on `device`
    (the card unless the caller asks for another)."""

    def __init__(self, cam: Pinhole, params: Optional[FlameParams] = None,
                 queue_size: int = 8,
                 alarm_after_s: float = 1.0, fail_after_s: float = 5.0,
                 pose_source: str = "external", ba_refine: bool = False,
                 eval_gt_depth: bool = False,
                 trajectory_cap: int = 100_000, device=None):
        if pose_source not in ("external", "tracking"):
            raise ValueError(pose_source)
        if pose_source == "tracking":
            raise NotImplementedError(
                "pose_source='tracking' (direct tracking and the pose "
                "graph) is not ported yet: ROADMAP.md queue 1, item 11")
        if ba_refine:
            raise NotImplementedError(
                "ba_refine (windowed bundle adjustment) is not ported yet: "
                "ROADMAP.md queue 1, item 12")
        self.pose_source = pose_source
        # Fold the GT confusion matrix into the stats when a frame
        # carries a depth map (offline evaluation harness).
        self.eval_gt_depth = eval_gt_depth
        # (img_id, time, pose) per processed frame; trajectory_cap=0 keeps
        # them all, else a rolling window.
        self.trajectory_cap = int(trajectory_cap)
        self.trajectory: collections.deque[tuple[int, float, SE3]] = (
            collections.deque(
                maxlen=self.trajectory_cap if self.trajectory_cap > 0
                else None))
        self.cam = cam
        self.params = params or FlameParams()
        self.engine = Flame(cam.width, cam.height, cam=cam,
                            params=self.params, device=device)
        self.queue: ThreadSafeQueue[InputFrame] = ThreadSafeQueue(queue_size)
        self.on_mesh: list[Callable] = []
        self.on_idepth: list[Callable] = []
        self.on_stats: list[Callable] = []
        self.on_heartbeat: list[Callable] = []
        self._alarm_after = alarm_after_s
        self._fail_after = fail_after_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._load = LoadTracker()

        self._n_proc = 0
        self._first_pf_id: Optional[int] = None
        self._pf_subsample = self.params.input.poseframe_subsample_factor
        self._last_pose: Optional[tuple[float, SE3]] = None
        self._last_success_time = time_mod.perf_counter()
        self._t_start = time_mod.perf_counter()
        self.health = Health.READY
        # Promote the next successful frame to a poseframe when a
        # scheduled poseframe fails in the engine.
        self._force_pf = False

    # -- producer side (the "subscriber callback") -----------------------
    def push_frame(self, img_id: int, time: float, quat=None, trans=None,
                   gray=None, depth=None) -> bool:
        """Thread-safe ingest; drops the frame when the queue is full
        (reference drop-newest semantics). Returns False if dropped."""
        if quat is None or trans is None:
            raise ValueError("external pose_source requires quat/trans")
        if not isinstance(gray, torch.Tensor):
            gray = np.asarray(gray, np.float32)
        return self.queue.push(InputFrame(
            img_id=img_id, time=time, quat=np.asarray(quat, np.float32),
            trans=np.asarray(trans, np.float32), gray=gray, depth=depth))

    def poseframe_callback(self, pf_ids, pf_poses: SE3):
        """External pose-graph update (reference poseframeCallback): infer
        the poseframe id pattern from the first message, retro-correct
        keyframe poses, prune absent poseframes."""
        pf_ids = [int(i) for i in np.asarray(pf_ids).ravel()]
        if self._first_pf_id is None and pf_ids:
            self._first_pf_id = pf_ids[0]
            if len(pf_ids) > 1:
                self._pf_subsample = pf_ids[1] - pf_ids[0]
        self.engine.update_poseframe_poses(pf_ids, pf_poses)
        self.engine.prune_poseframes(pf_ids)

    # -- lifecycle -------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._main, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        # The engine's worker thread goes too (reference: the nodelet's
        # destructor joins its processing thread, flame_nodelet.cc:406).
        self.engine.shutdown()

    def run_until_idle(self, idle_timeout: float = 0.25):
        """Synchronous drain (tests, batch use): process queued frames in
        the caller's thread until the queue stays empty."""
        while True:
            frame = self.queue.pop(timeout=idle_timeout)
            if frame is None:
                return
            self._process(frame)

    # -- consumer side ---------------------------------------------------
    def _main(self):
        while not self._stop.is_set():
            frame = self.queue.pop(timeout=0.1)
            now = time_mod.perf_counter()
            starved = now - self._last_success_time
            new_health = (Health.FAIL if starved > self._fail_after else
                          Health.ALARM if starved > self._alarm_after else
                          Health.READY)
            if new_health != self.health:
                self.health = new_health
                for cb in self.on_heartbeat:
                    cb(self.health)
            if frame is None:
                continue
            self._process(frame)

    def _angular_rate(self, frame: InputFrame, pose: SE3) -> float:
        if self._last_pose is None:
            return 0.0
        t_prev, prev = self._last_pose
        dt = max(frame.time - t_prev, 1e-6)
        rel = prev.inverse() @ pose
        ang = float(torch.linalg.vector_norm(rel.log()[3:]))
        return float(np.degrees(ang)) / dt

    def _process(self, frame: InputFrame):
        p = self.params
        if frame.img_id % p.input.subsample_factor:
            return
        if self._first_pf_id is None:
            self._first_pf_id = frame.img_id
        scheduled_pf = ((frame.img_id - self._first_pf_id)
                        % max(self._pf_subsample, 1)) == 0
        pose = SE3.from_quat_trans(frame.quat, frame.trans)
        is_pf = scheduled_pf or self._force_pf
        ang_rate = self._angular_rate(frame, pose)
        self._last_pose = (frame.time, pose)

        t0 = time_mod.perf_counter()
        gt = (frame.depth if (self.eval_gt_depth and frame.depth is not None
                              and has_ground_truth(frame.depth)) else None)
        ok = self.engine.update(frame.time, frame.img_id, pose, frame.gray,
                                is_pf, gt_depth=gt)
        if not ok:
            if is_pf:
                # The engine failed the poseframe: promote the next
                # successful frame.
                self._force_pf = True
            return
        if is_pf:
            self._force_pf = False
        self.trajectory.append((frame.img_id, frame.time, pose))
        self._n_proc += 1
        self._last_success_time = time_mod.perf_counter()

        # Angular-rate publish gate (cc:644-662).
        gated = (p.output.max_angular_rate > 0
                 and ang_rate > p.output.max_angular_rate)
        if not gated:
            if self.on_mesh and p.output.mesh:
                mesh = self.engine.get_inverse_depth_mesh()
                for cb in self.on_mesh:
                    cb(frame.img_id, frame.time, mesh)
            if self.on_idepth and (p.output.idepthmap or p.output.depthmap):
                m = self.engine.get_inverse_depth_map()
                for cb in self.on_idepth:
                    cb(frame.img_id, frame.time, m)

        if self.on_stats and p.output.stats:
            st = self.engine.stats_
            rec = self.engine.flush_stats()
            elapsed = time_mod.perf_counter() - self._t_start
            rec.update({
                "img_id": frame.img_id,
                "timestamp": frame.time,
                "queue_size": len(self.queue),
                "num_dropped": self.queue.num_dropped,
                "fps": self._n_proc / max(elapsed, 1e-6),
                "process_frame_ms":
                    (time_mod.perf_counter() - t0) * 1e3,
                "latency_ms":
                    (time_mod.perf_counter() - frame.recv_time) * 1e3,
                "angular_rate_deg_s": ang_rate,
                "publish_gated": bool(gated),
                "update_ms": st.timings("update"),
            })
            if self._n_proc % p.output.load_integration_factor == 0:
                snap = self._load.get()
                rec.update({
                    "pid_load_cpu": snap.pid_load.cpu,
                    "pid_load_mem": snap.pid_load.mem,
                    "sys_load_cpu": snap.sys_load.cpu,
                    "sys_load_mem": snap.sys_load.mem,
                    "max_load_cpu": snap.max_load.cpu,
                    "max_load_mem": snap.max_load.mem,
                })
            for cb in self.on_stats:
                cb(rec)
