"""The one traffic generator: camera streams moving through the synthetic
room, every stream's path drawn from the mix and the seed, its frames
rendered once in set-up into a host uint8 pool.

A mix file (`traffic/<mix>.json`) gives the parameters. The keys of the
paths (`PATH_KEYS`):

- `streams`: S cameras;
- `steps_per_s`: the step rate the pool is sized for. A stream's pool
  holds `pool_frames(mix, seconds)` frames: the warm-up steps and twice
  this rate over the window, so a run at up to twice the rate shows a
  new view at every step. Step k shows pool frame `pool_index(k, P)`,
  which runs forward and reverses only at the end of the pool, so the
  pose never jumps;
- `fps`: the frame clock of the timestamps;
- `warmup_updates`: steps run in set-up before the window (a multiple of
  the poseframe period covers both step kinds and fills the graph);
- `center_x`, `center_y`, `center_z` [lo, hi]: the box the middle of a
  stream's path is drawn from (RDF world, metres; the room spans x
  +-2.5, y +-1.5, z -1..5, back wall at z = 4);
- `amp_x_m`, `amp_z_m` [lo, hi]: the horizontal path is a Lissajous
  figure, x and z each a sine about the middle with these amplitudes;
- `speed_m_per_frame` [lo, hi]: the peak speed along x, hand-held
  (it sets the x period, 2 pi amp_x / speed);
- `z_period_ratio` [lo, hi]: the z period over the x period, drawn away
  from small whole ratios, so the figure does not close within a run;
- `yaw`, `pitch` [lo, hi]: the heading, radians; `yaw_swing` and
  `yaw_period_frames` [lo, hi]: a slow sway of the yaw; `bob_m` and
  `bob_period_frames` [lo, hi]: a vertical bob;
- `layout_seed`: the S paths are drawn once from it, the same for every
  run; `--seed` then deals them to the streams in its own order and
  moves each by up to `jitter_m` metres (middle) and `jitter_rad`
  radians (yaw, pitch and the phases of the sines);
- `check_streams`: how many streams the correctness check replays, one
  drawn from each of that many equal blocks of the stream axis.

`driver` names the program that serves the mix (`drivers/<driver>.py`),
which reads any further keys itself.

So every seed gets the same number of streams, frames and steps and
nearly the same views, hence nearly the same work; the frames still
differ from seed to seed."""
from __future__ import annotations

import json
import math

import numpy as np

PATH_KEYS = ("driver", "streams", "steps_per_s", "fps", "warmup_updates",
             "center_x", "center_y", "center_z", "amp_x_m", "amp_z_m",
             "speed_m_per_frame", "z_period_ratio", "yaw", "pitch",
             "yaw_swing", "yaw_period_frames", "bob_m", "bob_period_frames",
             "layout_seed", "jitter_m", "jitter_rad", "check_streams")


def load_mix(path: str, keys=PATH_KEYS) -> dict:
    with open(path) as f:
        mix = json.load(f)
    missing = [k for k in keys if k not in mix]
    if missing:
        raise ValueError(f"{path}: missing {missing}")
    return mix


def _rng(seed: int, salt: int) -> np.random.Generator:
    s = int(seed)
    return np.random.default_rng([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF,
                                  salt])


def pool_frames(mix: dict, seconds: float) -> int:
    """Frames a stream's pool holds for a window of `seconds`."""
    return (int(mix["warmup_updates"]) + 2
            + math.ceil(2.0 * float(mix["steps_per_s"]) * float(seconds)))


def pool_index(k: int, P: int) -> int:
    """Pool frame of step k: forward to P-1, then back, and again."""
    if P == 1:
        return 0
    m = k % (2 * (P - 1))
    return m if m < P else 2 * (P - 1) - m


def _quat(yaw: np.ndarray, pitch: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of R_y(yaw) R_x(pitch), float64 [..., 4]."""
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    return np.stack([cy * cp, cy * sp, sy * cp, -sy * sp], -1)


def trajectories(mix: dict, seed: int, P: int):
    """Camera-to-world poses of every stream's first P path frames:
    (q [S, P, 4], t [S, P, 3]) float32. Frame p is the same whatever P."""
    S = int(mix["streams"])
    layout = np.random.default_rng(int(mix["layout_seed"]))

    def draw(key):
        lo, hi = mix[key]
        return layout.uniform(lo, hi, S)

    cx, cy, cz = draw("center_x"), draw("center_y"), draw("center_z")
    ax, az = draw("amp_x_m"), draw("amp_z_m")
    tx = 2 * math.pi * ax / draw("speed_m_per_frame")
    tz = tx * draw("z_period_ratio")
    tyaw, tbob = draw("yaw_period_frames"), draw("bob_period_frames")
    yaw0, pitch0 = draw("yaw"), draw("pitch")
    phases = layout.uniform(0.0, 2 * math.pi, (4, S))
    rng = _rng(seed, 1)
    order = rng.permutation(S)
    jm, jr = float(mix["jitter_m"]), float(mix["jitter_rad"])
    cx, cy, cz = (x[order] + rng.uniform(-jm, jm, S) for x in (cx, cy, cz))
    yaw0, pitch0 = (x[order] + rng.uniform(-jr, jr, S)
                    for x in (yaw0, pitch0))
    phases = phases[:, order] + rng.uniform(-jr, jr, (4, S))
    ax, az, tx, tz, tyaw, tbob = (x[order] for x in
                                  (ax, az, tx, tz, tyaw, tbob))
    p = np.arange(P, dtype=np.float64)[None, :]

    def wave(period, phase):
        return np.sin(2 * math.pi * p / period[:, None] + phase[:, None])

    t = np.stack([cx[:, None] + ax[:, None] * wave(tx, phases[0]),
                  cy[:, None] + mix["bob_m"] * wave(tbob, phases[1]),
                  cz[:, None] + az[:, None] * wave(tz, phases[2])], -1)
    yaw = yaw0[:, None] + mix["yaw_swing"] * wave(tyaw, phases[3])
    q = _quat(yaw, np.broadcast_to(pitch0[:, None], yaw.shape))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.astype(np.float32), t.astype(np.float32)


def render_pool(cam: dict, q: np.ndarray, t: np.ndarray, device,
                chunk: int = 32) -> np.ndarray:
    """uint8 [S, P, H, W] host frames of every pose, rendered on
    `device` in chunks."""
    import torch
    from flamebench.render import render_room
    S, P = q.shape[:2]
    qf = torch.from_numpy(q.reshape(S * P, 4)).to(device)
    tf = torch.from_numpy(t.reshape(S * P, 3)).to(device)
    out = np.empty((S * P, cam["height"], cam["width"]), np.uint8)
    for a in range(0, S * P, chunk):
        out[a:a + chunk] = render_room(cam, qf[a:a + chunk],
                                       tf[a:a + chunk]).cpu().numpy()
    return out.reshape(S, P, cam["height"], cam["width"])


def check_streams(mix: dict, seed: int) -> list:
    """The streams the correctness check replays: one drawn from each of
    `check_streams` equal blocks of the stream axis."""
    S, n = int(mix["streams"]), int(mix["check_streams"])
    rng = _rng(seed, 2)
    edges = np.linspace(0, S, n + 1).astype(int)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges, edges[1:])]
