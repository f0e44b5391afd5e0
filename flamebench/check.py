"""The comparison that decides `correct`.

After the window closes, `memory_peak_bytes` is read and the program is
freed, the plain reference (`reference/engine.py`, one stream at a time,
no kernel, float32 only) replays the checked streams from their first
frame, as the cell's driver sets out (`drivers/<driver>.py`, `replay`):
every frame the program was given for them in set-up and in the window,
with the same poses, frame ids, poseframe schedule and keyframe slots.
It works the whole state out again; it is handed nothing the program
made.

Numbers compared, each against its limit (`LIMITS`):

- stats_gap: the widest gap, over every step and every key of the
  checked streams' stats rows (feature, vertex, triangle and edge counts,
  coverage, filter outcome counts, detections, NLTGV2 costs, photometric
  error, health), of |program - reference| / max(|reference|, 1);
- slots_differ: feature slots whose validity, keyframe or birth frame
  differ, and vertices whose graph membership differs, at the end;
- filter_gap: the widest |mu| gap of the feature filter's inverse-depth
  means over the slots valid on both sides (1/m);
- filter_var_gap: the widest gap of the filter's inverse-depth
  variances over the same slots ((1/m)^2);
- topology_differ: installed triangle and edge slots that differ;
- vertex_gap: the widest gap of the NLTGV2-smoothed vertex inverse
  depths over vertices in the graph on both sides (1/m);
- map_gap: the widest gap of the last dense inverse-depth maps (1/m),
  a pixel covered on one side only (NaN on the other) counting as an
  infinite gap.

A NaN on one side of a gap counts as an infinite gap, on both sides as
none."""
from __future__ import annotations

import numpy as np

# Set from the readings in PERF.md §2 ("The check").
LIMITS = {
    "stats_gap": 1e-3,
    "slots_differ": 0,
    "filter_gap": 1e-4,
    "filter_var_gap": 1e-4,
    "topology_differ": 0,
    "vertex_gap": 1e-4,
    "map_gap": 1e-4,
}


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    d = np.where(np.isnan(a) & np.isnan(b), 0.0,
                 np.where(np.isnan(d), np.inf, d))
    return float(d.max()) if d.size else 0.0


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared (module docstring)."""
    rp, rr = prog["rows"], ref["rows"]
    if rp.shape != rr.shape:
        return {k: float("inf") for k in LIMITS}
    rel = np.abs(rp - rr) / np.maximum(np.abs(rr), 1.0)
    rel = np.where(np.isnan(rel), np.inf, rel)
    both = prog["valid"] & ref["valid"]
    slots = (int((prog["valid"] != ref["valid"]).sum())
             + int((both & ((prog["kf_idx"] != ref["kf_idx"])
                            | (prog["frame_id"] != ref["frame_id"]))).sum())
             + int((prog["in_graph"] != ref["in_graph"]).sum()))
    g = prog["in_graph"] & ref["in_graph"]

    def topo(rows_p, rows_r, vp, vr):
        live = vp | vr
        return int((live & ((vp != vr)
                            | (rows_p != rows_r).any(-1))).sum())
    return {
        "stats_gap": float(rel.max()) if rel.size else 0.0,
        "slots_differ": slots,
        "filter_gap": _gap(prog["mu"][both], ref["mu"][both]),
        "filter_var_gap": _gap(prog["var"][both], ref["var"][both]),
        "topology_differ": (topo(prog["tris"], ref["tris"],
                                 prog["tri_valid"], ref["tri_valid"])
                            + topo(prog["edges"], ref["edges"],
                                   prog["edge_valid"], ref["edge_valid"])),
        "vertex_gap": _gap(prog["vtx_x"][g], ref["vtx_x"][g]),
        "map_gap": _gap(prog["idepth_map"], ref["idepth_map"]),
    }


def verdict(numbers: dict) -> tuple:
    """(correct, {name: {"value", "limit"}})."""
    out = {k: {"value": numbers[k], "limit": v} for k, v in LIMITS.items()}
    return all(v["value"] <= v["limit"] for v in out.values()), out
