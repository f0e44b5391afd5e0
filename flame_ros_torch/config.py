"""Typed configuration tree for the PyTorch/CUDA FLaME engine.

The same parameter tree, with the same field names, as the JAX package's
`flame_ros_tpu/config.py`, so a dict or YAML file written for one loads
unchanged into the other. It mirrors the reference rosparam YAML
vocabulary (reference: cfg/flame_nodelet.yaml:1-92,
cfg/flame_offline_tum.yaml, param loading at
src/flame_nodelet.cc:161-263) as frozen dataclasses, extended with
capacity knobs (static buffer sizes, search-sample counts, primal-dual
iteration counts) that replace the reference's `threading/openmp/*` CPU
tuning section.

Field names keep the JAX package's vocabulary. In this package
`use_pallas_raster` means "the hand-written raster kernel"
(`ops/raster_cuda.py` + `csrc/raster.cu`), and `pallas_raster_kernel`
picks which of its kernels ("v4" or "v2"). Comments below that quote
timings were measured for the JAX package on a TPU; they are history,
not numbers of this package.

Loading follows the reference's fail-fast semantics: `FlameParams.from_dict`
raises KeyError-style errors on unknown keys so config typos surface
immediately (reference getParamOrFail, src/utils.h:60-67 exits on a missing
key; we invert it — all keys have defaults, but unknown keys are fatal).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping

import yaml


def _replace_from(obj, d: Mapping[str, Any], path: str):
    """Recursively apply a nested dict onto a dataclass tree, fail-fast."""
    fields = {f.name: f for f in dataclasses.fields(obj)}
    updates = {}
    for key, val in d.items():
        if key not in fields:
            raise KeyError(f"Unknown config key: {path}{key}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, Mapping):
            updates[key] = _replace_from(cur, val, f"{path}{key}/")
        else:
            updates[key] = type(cur)(val) if cur is not None and val is not None else val
    return dataclasses.replace(obj, **updates)


@dataclass(frozen=True)
class DetectionParams:
    """Feature detection (reference cfg features/detection, README.md:204-210)."""
    min_grad_mag: float = 5.0    # Minimum gradient magnitude for a detection.
    min_error: float = 100.0     # Minimum photo error before redetection in a cell.
    win_size: int = 16           # Detection grid cell size (win_size x win_size).


@dataclass(frozen=True)
class TrackingParams:
    """Epipolar tracking (reference cfg features/tracking)."""
    win_size: int = 5            # Patch length along epipolar line (odd).
    max_dropouts: int = 5        # Consecutive failures before a feature dies.
    epipolar_line_var: float = 4.0  # Image-noise variance on the epipolar line.
    max_idepth_var: float = 1.0  # Posterior variance above which a feature dies.


@dataclass(frozen=True)
class FeatureParams:
    do_letterbox: bool = False   # Restrict to middle third of image rows.
    detection: DetectionParams = field(default_factory=DetectionParams)
    tracking: TrackingParams = field(default_factory=TrackingParams)


@dataclass(frozen=True)
class Nltgv2Params:
    """NLTGV2-L1 primal-dual smoothing (reference cfg regularization/nltgv2,
    src/flame_nodelet.cc:246-263)."""
    adaptive_data_weights: bool = False  # Data weight = 1/idepth variance.
    rescale_data: bool = False           # Rescale data weights to mean 1.
    init_with_prediction: bool = True    # Warm-start vertex x from dense prediction.
    idepth_var_max: float = 0.01         # Max posterior var before graph insertion.
    data_factor: float = 0.15            # Data-vs-smoothness balance (lambda).
    step_x: float = 0.001                # Primal step size.
    step_q: float = 125.0                # Dual step size.
    # Extra-gradient (over-relaxation) factor. The reference default is
    # 0.25 with hand-tuned fixed steps; with diagonal preconditioning
    # (our default solver) theory and practice want 1.0.
    theta: float = 1.0
    min_height: float = -1e14            # Height gate for graph insertion.
    max_height: float = 1e14
    check_sticky_obstacles: bool = False


@dataclass(frozen=True)
class RegularizationParams:
    do_median_filter: bool = False   # Median filter over graph neighborhoods.
    do_lowpass_filter: bool = False  # Lowpass filter over graph neighborhoods.
    do_nltgv2: bool = True
    nltgv2: Nltgv2Params = field(default_factory=Nltgv2Params)


@dataclass(frozen=True)
class OutputParams:
    """Which products to compute/emit + display-only mesh filters
    (reference cfg output/*, filters applied at mesh publish time only —
    they do not change the underlying graph)."""
    quiet: bool = False
    mesh: bool = True
    idepthmap: bool = False
    depthmap: bool = False
    cloud: bool = False
    features: bool = False
    stats: bool = True
    load_integration_factor: int = 15
    scene_color_scale: float = 1.0
    filter_oblique_triangles: bool = True
    oblique_normal_thresh: float = 1.57
    oblique_idepth_diff_factor: float = 0.35
    oblique_idepth_diff_abs: float = 0.1
    filter_long_edges: bool = True
    edge_length_thresh: float = 0.333   # Fraction of image width.
    filter_triangles_by_idepth: bool = True
    min_triangle_idepth: float = 0.01
    max_angular_rate: float = 0.0       # deg/s; 0 disables the publish gate.


@dataclass(frozen=True)
class DebugParams:
    """Debug image renderings (reference cfg debug/*)."""
    wireframe: bool = True
    features: bool = True
    detections: bool = False
    matches: bool = False
    normals: bool = False
    idepthmap: bool = True
    text_overlay: bool = True
    flip_images: bool = False
    # Debug-rate stage profiling: re-measures the reference's 13-stage
    # timing vocabulary (msg/FlameStats.msg:31-46) by running each stage
    # standalone against the live engine state every Nth frame. The
    # product path stays fused; this costs several host syncs per sample.
    profile_stages: bool = False
    profile_stages_every: int = 30


@dataclass(frozen=True)
class InputParams:
    """Input stream handling (reference cfg input/*)."""
    camera_frame_id: str = "camera"
    camera_world_frame_id: str = "camera_world"
    subsample_factor: int = 1            # Process 1 out of N frames.
    poseframe_subsample_factor: int = 6  # New keyframe every N processed frames.
    use_poseframe_updates: bool = False  # Accept external pose-graph updates.
    poseframe_child_frame_id: str = "body"
    resize_factor: int = 1


@dataclass(frozen=True)
class EngineParams:
    """Capacity knobs — static shapes for device-resident buffers.

    These replace the reference's threading/openmp section: the
    parallel-section tuning is the static tensor geometry the device
    code runs over.
    """
    max_features: int = 2048     # Feature slots (padded, validity-masked).
    max_vertex_degree: int = 16  # Incidence-list budget per graph vertex.
    max_keyframes: int = 8       # Keyframe (poseframe) ring-buffer depth.
    # Inverse-depth samples per epipolar search. 16 keeps the search
    # Nyquist-sampled (the per-feature pyramid-level pick guarantees <= 1
    # sample per level-pixel at any window width) and halves the gather
    # volume of the hottest op — measured 7.1 vs 12.1 ms at VGA/2048
    # lanes on v5e with no accuracy change on the synthetic GT suite.
    num_search_samples: int = 16
    pd_iters_per_frame: int = 10  # NLTGV2 primal-dual sweeps per frame.
    # Convergence gate for the per-frame sweeps: > 0 exits the sweep
    # loop once max |x change| per sweep falls below this (the engine
    # warm-starts from the previous frame, so steady-state frames
    # converge in 1-2 sweeps). Default 1e-4 idepth units — measured
    # accuracy-IDENTICAL on the VGA acceptance run and ~0.3 ms/frame
    # faster on v5e (6.49 -> 6.14, twice reproduced; BENCH_NOTES
    # round 3). 0 = fixed pd_iters_per_frame unrolled sweeps.
    pd_gate_tol: float = 1e-4
    sigma_window: float = 2.0    # Search range = mu +/- sigma_window * sigma.
    idepth_min: float = 1e-3     # Global inverse-depth search bounds.
    idepth_max: float = 4.0
    init_idepth: float = 0.5     # Prior mean for brand-new features (1/m).
    init_idepth_var: float = 0.25  # Prior variance for new features.
    ambiguous_match_ratio: float = 0.85  # 2nd-best/best cost gate.
    max_cost: float = 800.0      # Max accepted SSD matching cost.
    min_ref_patch_grad: float = 1.0  # Min gradient along epipolar dir in ref.
    compute_dtype: str = "float32"
    # Keyframe-ring recycling policy: True re-anchors the recycled
    # slot's features to the newest surviving keyframe (projected
    # position + transformed idepth; variance Jacobian-scaled and
    # 2x-inflated, with NO absolute floor — flooring at the init prior
    # was measured to push every re-anchored feature out of the
    # graph-insertion gate, a 5 pp recall dip; engine.py _pf_branch);
    # False mass-kills them (the pre-round-5
    # behavior — measured to cause a redetection wave that masks
    # 60-90% of the streaming-path dense map for ~4 poseframe periods
    # at every ring wrap; engine.py _pf_branch comment).
    reanchor_on_evict: bool = True
    # Epipolar candidate sampling strategy: "line" (sliding-window sweep
    # — one gather of S+P-1 points along the epipolar curve, windows
    # share taps; 1/patch_size the random HBM reads) or "patch" (exact
    # per-candidate warp of the reference patch rays; more gathers,
    # slightly more faithful at strong perspective foreshortening).
    epipolar_mode: str = "line"
    # Sampling stride of the per-frame photometric-error telemetry pass
    # (reference publishes photo error per frame; we estimate the same
    # mean on a strided grid and rescale the total to dense-equivalent).
    # At the default detection win_size=16, stride 4 still averages 16
    # samples per cell for min_error redetection. Stride 2 measured
    # ~3.5 ms/frame at VGA on v5e; stride 4 ~0.9 ms.
    photo_stride: int = 4
    # Brightness-offset-invariant epipolar matching (zero-mean SSD):
    # turn on for auto-exposure cameras (e.g. TUM RGB-D); off preserves
    # the reference's raw-SSD behavior. DEFAULT DECIDED BY RECORDED A/B
    # (round 4, VGA/200-frame acceptance protocol, PARITY.md): under
    # exposure churn zms wins 3.8x rmse — but on constant-exposure
    # regimes the patch MEAN is itself discriminative and discarding it
    # costs 1.3-1.6x rmse (easy 0.030->0.043, rotation 0.029->0.038,
    # low-texture 0.028->0.045; delta1 0.96->0.93-0.96). So the default
    # stays OFF (reference parity); flip it per-camera when exposure
    # hunts.
    zero_mean_ssd: bool = False
    # The hand-written raster kernel (ops/raster_cuda.py + csrc/raster.cu;
    # the JAX package's field name is kept). None = auto: on for "cuda",
    # off for "cpu", where the plain raster runs. Resolved at Flame
    # construction (FlameParams.resolved).
    use_pallas_raster: bool | None = None
    # Which hand-written raster kernel runs when use_pallas_raster
    # resolves True: "v4" (exact per-tile candidate lists of any length
    # from a device sort; it has no budget and no fallback) or "v2"
    # (per-tile triangle-block ranges in original order).
    # "v3" runs v2, as in the JAX package, whose dispatch never reaches
    # its v3 kernel.
    pallas_raster_kernel: str = "v4"

    # NLTGV2 adjoint formulation: "gather" (the incidence-list gather,
    # exact f32) or "matmul" (one product per sweep with the [V, 2E]
    # incidence matrix over bf16-rounded per-edge contributions, the JAX
    # package's matrix-unit formulation; ops/nltgv2.py). None resolves
    # to "gather" on every device, as JAX's auto does off the TPU.
    nltgv2_adjoint: str | None = None

    # --- Spatial graph partitioning: the NLTGV2 sweep over vertical
    # strips of the Delaunay graph, one per part device, with a halo
    # exchange of boundary primals (parallel/spatial_pd.py; the
    # multi-stream runner on a part layout, MultiStreamRunner(mesh=
    # [[...]])). 1 = off (the unsharded sweep). Requires
    # max_features % spatial_parts == 0.
    spatial_parts: int = 1
    # Static halo budget H: owned-vertex slots exported per (part, ring
    # offset) pair per sweep. Must bound the partition's true boundary
    # size for every install (overflow raises at triangulation time).
    spatial_halo_budget: int = 128
    # Static per-part edge budget El (owned + replicated boundary
    # edges). 0 = auto: 1.75 * max_edges / spatial_parts + 128, rounded
    # up to a multiple of 8 — headroom over a balanced partition; a
    # pathologically unbalanced install raises.
    spatial_edge_budget: int = 0

    def spatial_edge_budget_resolved(self) -> int:
        if self.spatial_edge_budget:
            return self.spatial_edge_budget
        el = 1.75 * self.max_edges / max(self.spatial_parts, 1) + 128
        return -(-int(el) // 8) * 8

    @property
    def max_triangles(self) -> int:
        return 2 * self.max_features

    @property
    def max_edges(self) -> int:
        return 3 * self.max_features


@dataclass(frozen=True)
class PoseTrackingParams:
    """Direct-alignment pose tracker: failure gate + recovery (tracking
    mode is capability beyond the reference; the gate mirrors the
    reference's pose-failure semantics — frames whose pose cannot be
    resolved are DROPPED, not estimated-and-hoped:
    ros_sensor_streams/tracked_image_stream.cc:182-185 drops frames with
    failed tf lookups, flame_nodelet.cc:637-642 skips failed updates).

    Gate calibration (QVGA synthetic, recorded round 5): clean-run mean
    Huber costs sit at 3.7-7.8 intensity units; a full-frame occlusion
    reads 24.0 (the 3*huber_delta clip) on the first occluded frame and
    — if the occluded frame is allowed to become the tracking keyframe —
    0.0 forever after (white-on-white has zero residual AND zero valid
    gradient points), which is why the gate needs BOTH a cost ceiling
    and a valid/inlier floor."""
    # Mean Huber cost above which the frame's track is rejected
    # (~2x the clean-run envelope, under the 3*huber_delta=24 clip).
    fail_cost: float = 14.0
    # Reject when inliers (|r| < 2*huber_delta) fall below this fraction
    # of the VALID point set (valid = in-view, in-front, textured-in-ref
    # — low-texture scenes shrink the valid set; the fraction is of what
    # was actually observable, not of the fixed lane count).
    min_inlier_frac: float = 0.5
    # Reject when fewer than this many points were observable at all
    # (catches the degenerate zero-residual case: a textureless track
    # ref yields cost 0 with nothing measured).
    min_valid_points: int = 64
    # Consecutive rejected frames before the recovery path re-searches
    # the keyframe ring (ring_relocalize) instead of just coasting the
    # constant-velocity model.
    relocalize_after: int = 3
    # Discrete twist grid for the ring re-search: +/-{1..n_steps}*step
    # per axis, coordinate-descent `iters` rounds (models/tracking.py::
    # ring_relocalize; same shape as ba.py::discrete_pose_presearch).
    reloc_step: float = 0.05
    reloc_n_steps: int = 3
    reloc_iters: int = 4
    # A relocalization candidate must keep its coarse photometric cost
    # under this to be trusted as a re-track seed.
    max_reloc_cost: float = 18.0
    # --- windowed BA (ba_refine) point budget + sharded solver -------
    # Points per BA solve (selection: gather_ba_inputs, newest-keyframe-
    # owned features). 256 is the single-chip live default; pod-scale
    # dense-mapping configs raise it together with
    # engine.max_features / a denser detection grid.
    ba_budget: int = 256
    # Route the window solve through the point-sharded Schur solver
    # (models/ba.py::hybrid_bundle_adjust_sharded: the points split over
    # the visible cards, one sum of the Schur partial sums per
    # iteration). None = the JAX package's rule: shard when ba_budget >=
    # 16384 and >= 2 cards are visible (whether it pays on H100s is not
    # measured, PERF.md). True/False force it either way.
    ba_sharded: bool | None = None
    # BA gauge/point-anchor keyframe: "newest" (default; fresh
    # detections own the points when the pool has turnover) or
    # "most_owned" (saturated dense-pool configs — see
    # models/ba.py::gather_ba_inputs docstring for the measured
    # failure that makes this necessary).
    ba_anchor: str = "newest"


@dataclass(frozen=True)
class AnalysisParams:
    pass_in_truth: bool = False  # Feed GT idepth into update() (truth harness).


@dataclass(frozen=True)
class FlameParams:
    """Top-level parameter tree (reference flame::Params + frontend params)."""
    input: InputParams = field(default_factory=InputParams)
    output: OutputParams = field(default_factory=OutputParams)
    debug: DebugParams = field(default_factory=DebugParams)
    features: FeatureParams = field(default_factory=FeatureParams)
    regularization: RegularizationParams = field(default_factory=RegularizationParams)
    engine: EngineParams = field(default_factory=EngineParams)
    pose_tracking: PoseTrackingParams = field(
        default_factory=PoseTrackingParams)
    analysis: AnalysisParams = field(default_factory=AnalysisParams)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "FlameParams":
        return _replace_from(FlameParams(), d, "")

    @staticmethod
    def from_yaml(path: str) -> "FlameParams":
        with open(path) as f:
            d = yaml.safe_load(f) or {}
        # Tolerate reference-style keys we deliberately do not use.
        d.pop("threading", None)
        return FlameParams.from_dict(d)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def resolved(self, device) -> "FlameParams":
        """Resolve auto (None) knobs for a torch device ("cuda" or "cpu").

        On "cuda" the hand-written raster kernel is on (v4); on "cpu"
        the plain raster runs. An unset NLTGV2 adjoint resolves to the
        exact f32 incidence gather on both; "matmul" is kept when
        asked."""
        kind = device.type if hasattr(device, "type") else \
            str(device).split(":")[0]
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        eng = self.engine
        if eng.nltgv2_adjoint not in (None, "gather", "matmul"):
            raise ValueError(
                f"unknown nltgv2_adjoint {eng.nltgv2_adjoint!r}")
        if eng.pallas_raster_kernel not in ("v4", "v3", "v2"):
            raise ValueError(
                f"unknown pallas_raster_kernel {eng.pallas_raster_kernel!r}")
        updates = {}
        if eng.use_pallas_raster is None:
            updates["use_pallas_raster"] = kind == "cuda"
        if eng.nltgv2_adjoint is None:
            updates["nltgv2_adjoint"] = "gather"
        if not updates:
            return self
        return dataclasses.replace(
            self, engine=dataclasses.replace(eng, **updates))
