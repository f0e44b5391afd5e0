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
device they stay there).

With pose_source="tracking" the poses are estimated online (capability
beyond the reference): direct alignment against the latest keyframe's
dense idepth (`models/tracking.py::track_frame`) with a quality gate,
constant-velocity coasting, keyframe-ring relocalization after repeated
failures (`ring_relocalize`) and a windowed pose graph over keyframes
(`models/pose_graph.py`), optionally refined on every poseframe by
photometric windowed bundle adjustment over the keyframe ring
(`ba_refine=True`, `models/ba.py::hybrid_bundle_adjust`; at dense point
budgets `hybrid_bundle_adjust_sharded`, the points split over the visible
cards). The tracker's solves run on the engine's device; each
result comes back in one device-to-host copy, and the per-frame pose
bookkeeping (a few quaternion products) is done on those host tensors.
Each frame is uploaded and pyramided once: the tracker's 4-level pyramid
goes to `Flame.update(img_pyr=)`.
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
from flame_ros_torch.models.ba import (gather_ba_inputs, hybrid_bundle_adjust,
                                      hybrid_bundle_adjust_sharded)
from flame_ros_torch.models.engine import Flame
from flame_ros_torch.models.pose_graph import make_graph, optimize_pose_graph
from flame_ros_torch.models.tracking import (TrackResult, ring_relocalize,
                                             track_frame)
from flame_ros_torch.ops.pyramid import build_pyramid
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
    quat: Optional[np.ndarray]   # (w, x, y, z) camera-to-world RDF
    trans: Optional[np.ndarray]  # (None for both in tracking mode)
    gray: object          # [H, W] numpy array or tensor
    depth: Optional[object] = None
    recv_time: float = field(default_factory=time_mod.perf_counter)


class FlameNodelet:
    """pose_source:
    - "external": frames arrive with poses (the reference's tf lookups, or
      a dataset's ground truth);
    - "tracking": poses are estimated online by direct alignment against
      the latest keyframe's smoothed dense idepth, with a windowed pose
      graph over keyframes. A depth map on the bootstrap frame fixes the
      monocular scale; otherwise it is arbitrary.
    ba_refine: photometric windowed bundle adjustment over the keyframe
    ring on every poseframe (meaningful with pose_source="tracking";
    external poses are ground truth). pose_tracking.ba_sharded routes the
    window solve through the point-sharded solver: None shards when
    ba_budget >= 16384 and at least two cards are visible (the JAX
    package's rule; on the CPU there is one device), True always (over
    one device if only one is visible), False never.
    The engine runs on `device` (the card unless the caller asks for
    another)."""

    def __init__(self, cam: Pinhole, params: Optional[FlameParams] = None,
                 queue_size: int = 8,
                 alarm_after_s: float = 1.0, fail_after_s: float = 5.0,
                 pose_source: str = "external", ba_refine: bool = False,
                 eval_gt_depth: bool = False,
                 trajectory_cap: int = 100_000, device=None):
        if pose_source not in ("external", "tracking"):
            raise ValueError(pose_source)
        self.pose_source = pose_source
        # Fold the GT confusion matrix into the stats when a frame
        # carries a depth map (offline evaluation harness; in tracking
        # mode the depth is otherwise used only for the scale bootstrap
        # on the first frame — it never feeds estimation).
        self.eval_gt_depth = eval_gt_depth
        # (img_id, time, pose) per processed frame; trajectory_cap=0 keeps
        # them all, else a rolling window.
        self.trajectory_cap = int(trajectory_cap)
        self.trajectory: collections.deque[tuple[int, float, SE3]] = (
            collections.deque(
                maxlen=self.trajectory_cap if self.trajectory_cap > 0
                else None))
        # Windowed BA on every poseframe; the final cost of each solve.
        self.ba_refine = ba_refine
        self.ba_costs: list[float] = []
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
        # Promote the next successful frame to a poseframe: set when a
        # scheduled poseframe fails (in the engine, or in tracking mode
        # its pose), and when tracking recovers from an outage (the aged
        # tracking keyframe needs immediate replacement).
        self._force_pf = False

        # Tracking-mode state (poses are host tensors).
        self._track_ref = None        # (pyr4, idepth, T_w_ref)
        self._refresh_pending = False  # refresh track ref next processed frame
        self._last_rel: Optional[SE3] = None  # previous T_rc (motion model)
        self._prev_rel: Optional[SE3] = None
        self._pg_nodes: list[tuple[int, SE3]] = []   # (img_id, pose)
        self._pg_edges: list[tuple[int, int, SE3]] = []
        self.track_costs: list[float] = []
        # Failure detection and recovery: a diverged alignment fails the
        # frame (reference semantics for unresolvable poses,
        # flame_nodelet.cc:637-642, tracked_image_stream.cc:182-185)
        # instead of poisoning the map.
        self._track_fail_streak = 0    # consecutive rejected frames
        self._last_track: Optional[TrackResult] = None  # on the host
        self.n_track_failed_frames = 0  # frames dropped by the gate
        self.n_relocalizations = 0      # successful ring re-searches
        self._recovered = False  # refresh track ref right after recovery
        self._pending_cur_pyr = None

    # -- producer side (the "subscriber callback") -----------------------
    def push_frame(self, img_id: int, time: float, quat=None, trans=None,
                   gray=None, depth=None) -> bool:
        """Thread-safe ingest; drops the frame when the queue is full
        (reference drop-newest semantics). Returns False if dropped.
        quat/trans may be None in tracking mode."""
        if self.pose_source == "external" and (quat is None or trans is None):
            raise ValueError("external pose_source requires quat/trans")
        if not isinstance(gray, torch.Tensor):
            gray = np.asarray(gray, np.float32)
        return self.queue.push(InputFrame(
            img_id=img_id, time=time,
            quat=None if quat is None else np.asarray(quat, np.float32),
            trans=None if trans is None else np.asarray(trans, np.float32),
            gray=gray, depth=depth))

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

    def _track_ok(self, res: TrackResult) -> bool:
        """Quality gate on a direct-alignment result (on the host). Two
        failure signatures: a high residual (occlusion, flash, blur: the
        cost saturates toward the 3*huber_delta clip) and a degenerate
        near-zero residual with no observable points (a textureless
        reference tracks anything at cost 0)."""
        ptp = self.params.pose_tracking
        cost = float(res.final_cost)
        n_val = int(res.n_valid)
        n_inl = int(res.n_inliers)
        if not np.isfinite(cost):
            return False
        if n_val < ptp.min_valid_points:
            return False
        if cost > ptp.fail_cost:
            return False
        if n_inl < ptp.min_inlier_frac * n_val:
            return False
        return True

    def _track(self, ref_pyr, ref_idepth, cur_pyr, init: SE3) -> TrackResult:
        """track_frame at the nodelet's settings, read back to the host."""
        return track_frame(ref_pyr, ref_idepth, cur_pyr, init.q, init.t,
                           cam=self.cam, num_levels=4).to_host()

    def _try_relocalize(self, cur_pyr, guess: SE3) -> Optional[SE3]:
        """Re-search the keyframe ring for the current frame's pose
        (models/tracking.py::ring_relocalize). Returns a world-pose
        hypothesis T_w_c, or None if no keyframe yields a trusted
        coarse-cost match. The per-slot results and the ring's poses come
        back in one device-to-host copy."""
        ptp = self.params.pose_tracking
        st = self.engine.state
        rq, rt, rcost, rn = ring_relocalize(
            st.kf_pyrs, st.kf_q, st.kf_t, st.kf_valid,
            st.feat.uv_ref, st.feat.mu, st.feat.valid, st.feat.kf_idx,
            cur_pyr, guess.q, guess.t, cam=self.cam,
            step=ptp.reloc_step, n_steps=ptp.reloc_n_steps,
            iters=ptp.reloc_iters)
        host = torch.cat([rcost[:, None], rn[:, None].to(torch.float32),
                          rq, rt, st.kf_q, st.kf_t], dim=1).cpu()
        rcost, rn = host[:, 0].numpy(), host[:, 1].numpy()
        j = int(np.argmin(rcost))
        if (not np.isfinite(rcost[j]) or rcost[j] > ptp.max_reloc_cost
                or rn[j] < 24):
            return None
        T_jc = SE3(host[j, 2:6], host[j, 6:9])
        T_wj = SE3(host[j, 9:13], host[j, 13:16])
        return T_wj @ T_jc.inverse()

    def _estimate_pose(self, frame: InputFrame) -> Optional[SE3]:
        """Tracking mode: direct alignment against the current keyframe.

        Returns None when the frame's pose cannot be resolved (the gate
        rejected it and recovery did not land): the caller fails the
        frame — no engine.update, no trajectory entry (reference
        frame-drop semantics). While failing, the constant-velocity model
        keeps coasting so the re-track seed advances with the motion;
        after `relocalize_after` consecutive rejections each new frame
        also re-searches the keyframe ring before giving up."""
        dev = self.engine.device
        cur_pyr = build_pyramid(self.engine._on_device(frame.gray), 4)
        if self._track_ref is None:
            # Bootstrap: sensor depth, if any, fixes the monocular scale;
            # otherwise a flat prior (scale arbitrary until then).
            if frame.depth is not None and has_ground_truth(frame.depth):
                d = self.engine._on_device(frame.depth)
                idepth = torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-6),
                                     torch.full_like(d, float("nan")))
            else:
                idepth = torch.full(cur_pyr.shape[1:],
                                    self.params.engine.init_idepth,
                                    dtype=torch.float32, device=dev)
            self._track_ref = (cur_pyr, idepth, SE3.identity())
            self._last_rel = SE3.identity()
            return SE3.identity()
        ref_pyr, ref_idepth, T_w_ref = self._track_ref
        ptp = self.params.pose_tracking
        # Constant-velocity motion model: extrapolate one inter-frame step
        # beyond the last solution (identity init fails at the maximum
        # keyframe age, where the baseline exceeds the coarse level's
        # capture range).
        init = self._last_rel or SE3.identity()
        if self._prev_rel is not None and self._last_rel is not None:
            step = self._prev_rel.inverse() @ self._last_rel
            init = self._last_rel @ step
        res = self._track(ref_pyr, ref_idepth, cur_pyr, init)
        # Gate only once the engine has a real map (before it the ref
        # idepth is a bootstrap prior whose cost scale proves nothing).
        gate_active = self.engine.num_poseframes > 0
        accepted = res if (not gate_active or self._track_ok(res)) else None

        if accepted is None and gate_active \
                and self._track_fail_streak + 1 >= ptp.relocalize_after:
            # Recovery: re-search the keyframe ring from the coasted
            # world-pose guess, re-track from the winning hypothesis and
            # re-apply the same gate.
            guess = T_w_ref @ init.inverse()
            T_wc = self._try_relocalize(cur_pyr, guess)
            if T_wc is not None:
                init2 = T_wc.inverse() @ T_w_ref
                res2 = self._track(ref_pyr, ref_idepth, cur_pyr, init2)
                if self._track_ok(res2):
                    accepted = res2
                    self.n_relocalizations += 1

        self._last_track = accepted if accepted is not None else res
        if accepted is None:
            # Coast: commit the extrapolated step as if it had been
            # observed, so the next frame's init keeps advancing at
            # constant velocity instead of freezing at the last good pose.
            self._track_fail_streak += 1
            self.n_track_failed_frames += 1
            self._prev_rel, self._last_rel = self._last_rel, init
            return None
        self.track_costs.append(float(accepted.final_cost))
        T_rc = SE3(accepted.q, accepted.t)
        if self._track_fail_streak > 0:
            # Recovery frame: the map went unobserved during the outage.
            # Promote this frame to a poseframe, and refresh the tracking
            # keyframe right after its engine update (the aged ref that
            # survived the outage loses the track again within frames).
            self._force_pf = True
            self._recovered = True
        self._track_fail_streak = 0
        self._prev_rel = self._last_rel
        self._last_rel = T_rc
        self._pending_cur_pyr = cur_pyr
        return T_w_ref @ T_rc.inverse()

    def _refresh_track_ref(self, pose: SE3, cur_pyr=None):
        """New tracking keyframe from the engine's smoothed dense idepth."""
        if cur_pyr is None:
            return
        idepth = self.engine.get_inverse_depth_map()
        if idepth is None or not np.isfinite(idepth).any():
            return
        self._track_ref = (cur_pyr, self.engine._on_device(idepth), pose)
        self._last_rel = SE3.identity()
        self._prev_rel = None

    def _pose_graph_update(self, img_id: int, pose: SE3):
        """Record a keyframe node and its odometry edge; every second node
        (from the third on) optimize the last max_keyframes nodes on the
        engine's device and retro-correct the engine's keyframe poses."""
        if self._pg_nodes:
            _, prev_pose = self._pg_nodes[-1]
            self._pg_edges.append(
                (len(self._pg_nodes) - 1, len(self._pg_nodes),
                 prev_pose.inverse() @ pose))
        self._pg_nodes.append((img_id, pose))
        window = self.params.engine.max_keyframes
        if len(self._pg_nodes) >= 3 and len(self._pg_nodes) % 2 == 0:
            nodes = self._pg_nodes[-window:]
            off = len(self._pg_nodes) - len(nodes)
            edges = [(i - off, j - off, m) for i, j, m in self._pg_edges
                     if i >= off and j >= off]
            if not edges:
                return
            poses = SE3(torch.stack([p.q for _, p in nodes]),
                        torch.stack([p.t for _, p in nodes]))
            meas = SE3(torch.stack([m.q for _, _, m in edges]),
                       torch.stack([m.t for _, _, m in edges]))
            q, t, _ = optimize_pose_graph(
                make_graph(poses, [(i, j) for i, j, _ in edges], meas,
                           device=self.engine.device),
                num_iters=5)
            qt = torch.cat([q, t], dim=1).cpu()
            ids = [i for i, _ in nodes]
            self.engine.update_poseframe_poses(ids, SE3(qt[:, :4],
                                                        qt[:, 4:]))
            self._pg_nodes = (self._pg_nodes[:-len(nodes)]
                              + [(nid, SE3(qt[k, :4], qt[k, 4:]))
                                 for k, (nid, _) in enumerate(nodes)])

    def _ba_refine(self):
        """Photometric windowed bundle adjustment over the live keyframe
        ring: the gauge is the anchor keyframe (pose_tracking.ba_anchor),
        whose features give the depth parameters; the refined poses
        retro-correct the engine through update_poseframe_poses (the
        reference poseframeCallback semantics, flame_nodelet.cc:414-479,
        with the correction computed in-process). The selection runs on
        the device and the host reads it in one copy; the solve's poses
        and cost come back in one more."""
        st = self.engine.state
        ptp = self.params.pose_tracking
        P = ptp.ba_budget
        packed = gather_ba_inputs(
            st.kf_valid, st.kf_ids, st.feat.valid, st.feat.kf_idx,
            st.feat.uv_ref, st.feat.mu, budget=P, anchor=ptp.ba_anchor)
        buf = packed.cpu().numpy()
        K = int(st.kf_valid.shape[0])
        kf_valid = buf[:K] > 0.5
        kf_ids = buf[K:2 * K].astype(np.int64)
        ref_slot = int(buf[2 * K])
        n_sel = int(buf[2 * K + 1])
        if kf_valid.sum() < 3 or n_sel < 24:
            return
        off = 2 * K + 2
        uv = packed[off:off + 2 * P].reshape(P, 2)
        d0 = packed[off + 2 * P:off + 3 * P]
        pv = packed[off + 3 * P:off + 4 * P] > 0.5

        # Roll the ring so that the gauge sits at index 0.
        def roll(a):
            return torch.roll(a, -ref_slot, 0)

        # One round of hybrid BA per poseframe: epipolar matches freed
        # from the wrong-pose line by 2-D LK supply the reprojection
        # channels; the per-poseframe cadence re-estimates the matches
        # from the previous call's poses. At dense budgets the window
        # solve's points split over the cards (ba_devices).
        win = (roll(st.kf_pyrs), roll(st.kf_q), roll(st.kf_t),
               roll(st.kf_valid), uv, d0, pv)
        kw = dict(cam=self.cam, num_iters=4, coarse_iters=2, level=1)
        devices = self.ba_devices(P)
        if devices is not None:
            res = hybrid_bundle_adjust_sharded(devices, *win, **kw)
        else:
            res = hybrid_bundle_adjust(*win, rounds=1, **kw)
        host = torch.cat([res.q, res.t, res.final_cost.expand(K, 1)],
                         dim=1).cpu().numpy()
        self.ba_costs.append(float(host[0, 7]))
        qt = np.roll(host[:, :7], ref_slot, axis=0)
        if not np.isfinite(qt).all():
            return
        live = np.flatnonzero(kf_valid)
        self.engine.update_poseframe_poses(
            [int(kf_ids[s]) for s in live],
            SE3(torch.from_numpy(qt[live, :4].copy()),
                torch.from_numpy(qt[live, 4:].copy())))

    def ba_devices(self, P: int):
        """The device list of the point-sharded BA solve, or None for the
        unsharded one. pose_tracking.ba_sharded None: shard when P >=
        16384 and at least two cards are visible (on the CPU there is one
        device); True: always. The list is the largest number of visible
        cards that divides P, starting at the engine's card (on the CPU,
        the one CPU device)."""
        use = self.params.pose_tracking.ba_sharded
        dev = self.engine.device
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        if use is None:
            use = P >= 16384 and n >= 2
        if not use:
            return None
        d = n
        while d > 1 and P % d:
            d -= 1
        if dev.type != "cuda":
            return [dev]
        return [torch.device("cuda", (dev.index + k) % n) for k in range(d)]

    def _process(self, frame: InputFrame):
        p = self.params
        if frame.img_id % p.input.subsample_factor:
            return
        if self._first_pf_id is None:
            self._first_pf_id = frame.img_id
        scheduled_pf = ((frame.img_id - self._first_pf_id)
                        % max(self._pf_subsample, 1)) == 0
        self._pending_cur_pyr = None
        if self.pose_source == "tracking":
            pose = self._estimate_pose(frame)
            if pose is None:
                if scheduled_pf:
                    # The modulo slot was missed: promote the next
                    # successful frame instead of waiting a full period.
                    self._force_pf = True
                # Pose unresolved: fail the frame (no engine.update, no
                # trajectory entry); telemetry still reports the failure.
                if self.on_stats and p.output.stats:
                    tr = self._last_track
                    rec = {
                        "img_id": frame.img_id,
                        "timestamp": frame.time,
                        "tracking_failed": True,
                        "track_fail_streak": self._track_fail_streak,
                        "track_cost": (float(tr.final_cost)
                                       if tr is not None else float("nan")),
                        "track_n_valid": (int(tr.n_valid)
                                          if tr is not None else 0),
                        "track_n_inliers": (int(tr.n_inliers)
                                            if tr is not None else 0),
                        "queue_size": len(self.queue),
                        "num_dropped": self.queue.num_dropped,
                    }
                    for cb in self.on_stats:
                        cb(rec)
                return
        else:
            pose = SE3.from_quat_trans(frame.quat, frame.trans)
        is_pf = scheduled_pf or self._force_pf
        ang_rate = self._angular_rate(frame, pose)
        self._last_pose = (frame.time, pose)

        t0 = time_mod.perf_counter()
        gt = (frame.depth if (self.eval_gt_depth and frame.depth is not None
                              and has_ground_truth(frame.depth)) else None)
        # Tracking mode hands the tracker's pyramid of this frame to the
        # engine, so the frame is uploaded and pyramided once.
        ok = self.engine.update(frame.time, frame.img_id, pose, frame.gray,
                                is_pf, gt_depth=gt,
                                img_pyr=self._pending_cur_pyr)
        if not ok:
            if is_pf:
                # The engine failed the poseframe: promote the next
                # successful frame.
                self._force_pf = True
            return
        if is_pf:
            self._force_pf = False
        self.trajectory.append((frame.img_id, frame.time, pose))
        if self.pose_source == "tracking":
            # Refresh the tracking keyframe one processed frame after the
            # poseframe: the engine retriangulates after the poseframe, so
            # that is the first dense map with the new detections. A state
            # flag, so it fires under any subsample/poseframe stride.
            if self._recovered:
                # Recovery frame: refresh against the current map now; the
                # post-poseframe refresh below still follows next frame.
                self._refresh_track_ref(pose, self._pending_cur_pyr)
                self._recovered = False
            if self._refresh_pending and self.engine.num_poseframes > 0:
                self._refresh_track_ref(pose, self._pending_cur_pyr)
                self._refresh_pending = False
            if is_pf:
                self._refresh_pending = True
                self._pose_graph_update(frame.img_id, pose)
                if self.ba_refine:
                    self._ba_refine()
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
            if self.pose_source == "tracking" and self._last_track is not None:
                tr = self._last_track
                rec.update({
                    "tracking_failed": False,
                    "track_cost": float(tr.final_cost),
                    "track_n_valid": int(tr.n_valid),
                    "track_n_inliers": int(tr.n_inliers),
                    "n_track_failed_frames": self.n_track_failed_frames,
                    "n_relocalizations": self.n_relocalizations,
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


def main(argv=None):
    """Deprecated entry, kept as in the JAX package: the network
    streaming server is `flame_ros_torch.frontends.serve`."""
    from flame_ros_torch.frontends.serve import main as serve_main
    return serve_main(argv)


if __name__ == "__main__":
    main()
