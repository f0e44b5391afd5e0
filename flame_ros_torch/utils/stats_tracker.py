"""Named timing/scalar stats tracker.

Capability parity with flame::utils::StatsTracker (reference usage:
src/flame_nodelet.cc:533-610 — tick()/tock() timer pairs, set() scalars,
stats()/timings() map accessors), with the engine's 13-stage timing
vocabulary (reference: msg/FlameStats.msg:31-46) preserved verbatim so
telemetry is comparable across implementations. Adds EMA smoothing and
JSONL export, which replace the reference's ROS stats messages.
"""
from __future__ import annotations

import json
import time
from typing import Dict

# The reference engine's stage-timing vocabulary (msg/FlameStats.msg:31-46).
STAGE_TIMINGS = (
    "update", "update_locking", "frame_creation", "interpolate", "keyframe",
    "detection", "detection_loop", "update_idepths", "project_features",
    "project_graph", "sync_graph", "triangulate", "median_filter",
    "lowpass_filter",
)

# The reference engine's scalar-stats vocabulary (msg/FlameStats.msg:6-27).
SCALAR_STATS = (
    "num_feats", "num_vtx", "num_tris", "num_edges", "coverage",
    "num_idepth_updates", "num_fail_max_var", "num_fail_max_dropouts",
    "num_fail_ref_patch_grad", "num_fail_ambiguous_match",
    "num_fail_max_cost",
    "nltgv2_total_smoothness_cost", "nltgv2_avg_smoothness_cost",
    "nltgv2_total_data_cost", "nltgv2_avg_data_cost",
    "total_photo_error", "avg_photo_error",
    "fps", "fps_max",
)


class StatsTracker:
    """tick/tock named wall-clock timers + named scalars."""

    def __init__(self, smoothing: float = 0.0):
        self._tick_starts: Dict[str, float] = {}
        self._timings: Dict[str, float] = {}
        self._stats: Dict[str, float] = {}
        self._smoothing = smoothing

    def tick(self, name: str) -> None:
        self._tick_starts[name] = time.perf_counter()

    def tock(self, name: str) -> float:
        t0 = self._tick_starts.get(name)
        if t0 is None:
            return 0.0
        ms = (time.perf_counter() - t0) * 1e3
        if self._smoothing > 0 and name in self._timings:
            ms = self._smoothing * self._timings[name] + (1 - self._smoothing) * ms
        self._timings[name] = ms
        return ms

    class _Scope:
        def __init__(self, tracker, name):
            self.tracker, self.name = tracker, name

        def __enter__(self):
            self.tracker.tick(self.name)
            return self

        def __exit__(self, *exc):
            self.tracker.tock(self.name)
            return False

    def scope(self, name: str) -> "StatsTracker._Scope":
        return StatsTracker._Scope(self, name)

    def set(self, name: str, value: float) -> None:
        self._stats[name] = float(value)

    def add(self, name: str, value: float) -> None:
        self._stats[name] = self._stats.get(name, 0.0) + float(value)

    def stats(self, name: str | None = None):
        if name is None:
            return dict(self._stats)
        return self._stats.get(name, 0.0)

    def timings(self, name: str | None = None):
        if name is None:
            return dict(self._timings)
        return self._timings.get(name, 0.0)

    def set_timing(self, name: str, ms: float) -> None:
        self._timings[name] = float(ms)

    def to_record(self, img_id: int, timestamp: float) -> dict:
        """One flat JSONL-able record per frame (replaces FlameStats msg)."""
        rec = {"img_id": int(img_id), "timestamp": float(timestamp)}
        rec.update({k: self._stats.get(k, 0.0) for k in SCALAR_STATS})
        rec.update({f"{k}_ms": self._timings.get(k, 0.0) for k in STAGE_TIMINGS})
        # Include any extra keys not in the fixed vocabulary.
        for k, v in self._stats.items():
            rec.setdefault(k, v)
        for k, v in self._timings.items():
            rec.setdefault(f"{k}_ms", v)
        return rec

    def dump_jsonl(self, fp, img_id: int, timestamp: float) -> None:
        fp.write(json.dumps(self.to_record(img_id, timestamp)) + "\n")
