"""A fleet of cameras on one device: `flame_ros_torch`'s
`MultiStreamRunner(cam, S, params)`, one `update(frames)` a step for all
S streams, then `flush_stats()`, which reads every stream's stats row
back; the next step is sent when that read returns. No ground truth.

Mix keys beyond the path's (`traffic.PATH_KEYS`): `runner`, the runner's
options, `{"deferred_triangulation": bool, "blocking_installs": bool}`
(each may be left out; both default to false). The reference follows
one schedule: the topology a poseframe round builds from step k's
vertices installs before step k + 1. Synchronous rounds keep it, and so
do deferred rounds with blocking installs; deferred rounds that install
whenever their thread is done do not, and are refused.

Set-up renders every stream's pool, builds the runner and runs the
mix's warm-up steps through `step()`, so every kernel is built, the
raster and Delaunay libraries are loaded, the allocator and the Delaunay
thread pool are warm, and the graph is full."""
from __future__ import annotations

import time

import numpy as np

from flamebench import traffic
from flamebench.harness import Step, merge

MIX_KEYS = traffic.PATH_KEYS + ("runner",)
RUNNER_OPTIONS = ("deferred_triangulation", "blocking_installs")


class Program:
    def __init__(self, config: dict, mix: dict, seed: int, seconds: float,
                 device, override: dict | None = None):
        from flame_ros_torch.config import FlameParams
        from flame_ros_torch.geometry.camera import Pinhole
        missing = [k for k in MIX_KEYS if k not in mix]
        if missing:
            raise ValueError(f"mix: missing {missing}")
        opts = mix["runner"]
        unknown = sorted(set(opts) - set(RUNNER_OPTIONS))
        if unknown:
            raise ValueError(f"mix: unknown runner options {unknown}")
        if (opts.get("deferred_triangulation")
                and not opts.get("blocking_installs")):
            raise ValueError("deferred rounds without blocking installs "
                             "have no fixed schedule to replay")
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = device
        c = config["camera"]
        self.cam = Pinhole(c["fx"], c["fy"], c["cx"], c["cy"], c["width"],
                           c["height"])
        params = config["params"]
        if override:
            params = merge(params, override)
        self.params = FlameParams.from_dict(params)
        self.S = int(mix["streams"])
        self.P = traffic.pool_frames(mix, seconds)
        self.pf_every = max(int(self.params.input.poseframe_subsample_factor),
                            1)
        self.k = 0             # global step index (warm-up included)
        self.rows = []         # every step's stats rows
        self.runner = None

    # -- inputs ---------------------------------------------------------
    def frames(self, k: int) -> list:
        p = traffic.pool_index(k, self.P)
        ts = k / float(self.mix["fps"])
        return [(ts, k, self.poses[s][p], self.pool[s, p])
                for s in range(self.S)]

    # -- set-up ---------------------------------------------------------
    def setup(self):
        import torch
        from flame_ros_torch.geometry.se3 import SE3
        from flame_ros_torch.parallel.multi_stream import MultiStreamRunner
        t0 = time.perf_counter()
        self.q, self.t = traffic.trajectories(self.mix, self.seed, self.P)
        self.pool = traffic.render_pool(self.config["camera"], self.q,
                                        self.t, self.device)
        self.render_s = time.perf_counter() - t0
        if torch.device(self.device).type == "cuda":
            # The peak the run reports is the program's, not the
            # renderer's.
            torch.cuda.reset_peak_memory_stats(self.device)
        self.poses = [[SE3(self.q[s, p], self.t[s, p])
                       for p in range(self.P)] for s in range(self.S)]
        opts = self.mix["runner"]
        self.runner = MultiStreamRunner(
            self.cam, self.S, self.params, device=self.device,
            deferred_triangulation=bool(opts.get("deferred_triangulation")))
        self.runner.blocking_installs = bool(opts.get("blocking_installs"))
        for _ in range(int(self.mix["warmup_updates"])):
            self.step()

    # -- one step -------------------------------------------------------
    def step(self) -> Step:
        clock = time.perf_counter
        frames = self.frames(self.k)
        is_pf = self.k % self.pf_every == 0
        a = clock()
        self.runner.update(frames)
        b = clock()
        rows = self.runner.flush_stats()
        c = clock()
        self.rows.append(rows)
        self.k += 1
        return Step(a, b, c, is_pf, self.S, rows)

    def mark(self) -> int:
        return len(self.runner.tri_round_s)

    def readings(self, mark: int) -> dict:
        return {"tri_round_s": list(self.runner.tri_round_s[mark:]),
                "streams": self.S}

    def hooks(self):
        from flame_ros_torch.ops import raster_cuda
        return ([(self.runner, "_poseframe_round",
                  "update.poseframe_round")],
                [(raster_cuda, "rasterize_tri_ids_v4_batched",
                  "raster_v4_batched")])

    # -- what the check reads -------------------------------------------
    def inputs(self) -> dict:
        return {"q": self.q, "t": self.t, "pool": self.pool,
                "steps": self.k}

    def outputs(self, streams: list) -> dict:
        """The program's answers for the checked streams, copied to the
        host after the window: every step's stats rows, the final state's
        leaves the check compares, and the last dense idepth maps."""
        from flame_ros_torch.models.engine import DEVICE_STATS_KEYS
        self.runner.drain_topologies()
        st = self.runner.states
        idx = list(streams)

        def take(x):
            return x[idx].detach().cpu().numpy()
        maps = self.runner.get_idepth_maps()[idx]
        rows = np.array([[[r[s][key] for key in DEVICE_STATS_KEYS]
                          for s in idx] for r in self.rows], np.float64)
        return {
            "rows": rows,                                # [K, n, keys]
            "mu": take(st.feat.mu), "var": take(st.feat.var),
            "valid": take(st.feat.valid), "kf_idx": take(st.feat.kf_idx),
            "frame_id": take(st.feat.frame_id),
            "vtx_x": take(st.vtx_x), "in_graph": take(st.vtx_in_graph),
            "tris": take(st.tris), "tri_valid": take(st.tri_valid),
            "edges": take(st.edges), "edge_valid": take(st.edge_valid),
            "idepth_map": maps,
        }

    def close(self):
        if self.runner is not None:
            self.runner.shutdown()
            self.runner = None


def check_streams(mix: dict, seed: int) -> list:
    return traffic.check_streams(mix, seed)


def replay(config: dict, mix: dict, inputs: dict, streams: list,
           device) -> dict:
    """The plain reference's answers for `streams` over every step the
    program ran, warm-up included: the same frames, poses, frame ids,
    poseframe schedule and keyframe slots, the topology of a poseframe
    installed before the next step. Keys as `Program.outputs`."""
    import torch
    from flamebench.reference.camera import Pinhole
    from flamebench.reference.engine import Stream
    c = config["camera"]
    cam = Pinhole(c["fx"], c["fy"], c["cx"], c["cy"], c["width"],
                  c["height"])
    pf_every = max(int(config["params"]["input"][
        "poseframe_subsample_factor"]), 1)
    K = int(config["params"]["engine"]["max_keyframes"])
    q, t, pool = inputs["q"], inputs["t"], inputs["pool"]
    P = pool.shape[1]
    keys = ("mu", "var", "valid", "kf_idx", "frame_id", "vtx_x",
            "in_graph", "tris", "tri_valid", "edges", "edge_valid",
            "idepth_map", "rows")
    out = {k: [] for k in keys}
    for s in streams:
        ref = Stream(config["params"], cam, device)
        rows, n_pf, idm = [], 0, None
        for k in range(inputs["steps"]):
            p = traffic.pool_index(k, P)
            is_pf = k % pf_every == 0
            stats, idm = ref.step(pool[s, p], q[s, p], t[s, p], k, is_pf,
                                  n_pf % K, k)
            n_pf += int(is_pf)
            rows.append(stats)
        st = ref.state
        vals = (st.feat.mu, st.feat.var, st.feat.valid, st.feat.kf_idx,
                st.feat.frame_id, st.vtx_x, st.vtx_in_graph, st.tris,
                st.tri_valid, st.edges, st.edge_valid, idm,
                torch.stack(rows))
        for k, v in zip(keys, vals):
            out[k].append(v.cpu().numpy())
        del ref
    res = {k: np.stack(v) for k, v in out.items()}
    res["rows"] = res["rows"].transpose(1, 0, 2).astype(np.float64)
    return res
