"""The port's multi-device layouts on the CPU: the multi-stream runner over
a stream-group device list, and the multi-process runner of
flame_ros_torch/parallel/dist_e2e.py (`gloo`, `--device cpu`).

- Stream groups: the runner on ["cpu", "cpu"] (two groups of one stream)
  against the plain runner over the 8 frames of
  tests/test_torch_multi_stream.py's sequence (96x128, 256 feature
  slots, GT depth, stream 1 one frame behind): every state leaf and every
  stats row equal bit for bit, after every frame; its checkpoint loads
  into the plain runner bit for bit; `make_mesh`'s layouts, and
  mesh="auto" on one device giving the plain path.
- Two worker processes (tests/test_distributed.py:62-140, on the port):
  QVGA, 13 frames, 3 poseframe rounds, one stream each. Each rank's
  payload (its `DIST_E2E_OK` line from `frames=` on: coverage, median
  idepth error, triangles and a hash of its idepth map and vertex
  idepths) equals the single-process run of the same two streams; a run
  with `--spatial` (each rank's stream over a 2-part layout) completes;
  and a run killed after writing its frame-7 checkpoint shards, restarted
  from them, ends with the uninterrupted run's payload exactly.
- Two worker processes of flame_ros_torch/parallel/dist_smoke.py
  (tests/test_distributed.py:58-59, on the port): one batched step whose
  feature axis pairs the two ranks (gloo all-gathers every sweep); both
  print `DIST_OK`, with the coverage of the same step in one process on
  the plain path, exactly.

The workers read the frames from one file rendered here, rather than
each rendering them; the single-process baseline runs in this process.
"""
import contextlib
import io
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from flame_ros_torch.config import FlameParams
from flame_ros_torch.datasets.synthetic import make_sequence
from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.geometry.se3 import SE3
from flame_ros_torch.models.engine import state_leaves
from flame_ros_torch.parallel import dist_e2e, dist_smoke
from flame_ros_torch.parallel.multi_stream import (MultiStreamRunner,
                                                   make_mesh)

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "flame_ros_torch.parallel.dist_e2e"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(frames_file, *extra):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", MODULE, str(rank), "2", str(port), "13",
         "--device", "cpu", f"--frames={frames_file}", *extra],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]


def _finish(procs, marker="DIST_E2E_OK", key="stream"):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"{marker} {key}={rank}" in out, out[-3000:]
    return outs


def _payloads(out: str, marker: str = "DIST_E2E_OK") -> dict:
    """{stream: its line from `frames=` on} of a run's output."""
    got = {}
    for line in out.splitlines():
        if line.startswith(marker + " "):
            s = int(line.split("stream=", 1)[1].split()[0])
            got[s] = line.split("frames=", 1)[1]
    return got


@pytest.fixture(scope="module")
def frames_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist") / "frames.npz")
    imgs, depths, q, t, ts = dist_e2e.render_frames("cpu")
    np.savez(path, imgs=imgs, depths=depths, q=q, t=t, ts=ts)
    return path


@pytest.fixture(scope="module")
def runs(frames_file, tmp_path_factory):
    """The uninterrupted two-process run (writing frame-7 shards) and the
    spatial one, side by side, while the single-process baseline runs
    here."""
    ck = str(tmp_path_factory.mktemp("ck") / "pod_a")
    plain = _start(frames_file, f"--ckpt={ck}", "--ckpt-at=7")
    spatial = _start(frames_file, "--spatial")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dist_e2e.main(0, 2, 0, 13, single=True, device="cpu",
                      frames_file=frames_file)
    torch.set_num_threads(1)
    return dict(plain=_finish(plain), ckpt=ck,
                spatial=_finish(spatial, "DIST_E2E_SPATIAL_OK"),
                single=_payloads(buf.getvalue()))


def test_two_process_runner_equals_single_process(runs):
    single = runs["single"]
    assert sorted(single) == [0, 1]
    for rank, out in enumerate(runs["plain"]):
        assert "pf_rounds=3" in out and "CKPT_SAVED" in out, out[-2000:]
        assert _payloads(out) == {rank: single[rank]}, (out[-2000:], single)
    assert "DIST_E2E_STATS streams=2" in runs["plain"][0]
    for p in (0, 1):
        assert os.path.exists(f"{runs['ckpt']}.p{p}.npz")


def test_two_process_spatial_runner(runs):
    for rank, out in enumerate(runs["spatial"]):
        assert "pf_rounds=3" in out, out[-2000:]
        assert rank in _payloads(out, "DIST_E2E_SPATIAL_OK")


def test_two_process_kill_and_restart_from_checkpoint(runs, frames_file,
                                                      tmp_path):
    """A run paused after its frame-7 shards are on disk loses rank 1 (a
    kill); a fresh pair of processes reloads the shards (each its own
    `.p<rank>.npz`) and replays the rest: its payloads equal the
    uninterrupted run's exactly."""
    ck = str(tmp_path / "pod_b")
    procs = _start(frames_file, f"--ckpt={ck}", "--ckpt-at=7",
                   "--pause-after-save=120")
    try:
        shards = [f"{ck}.p0.npz", f"{ck}.p1.npz"]
        deadline = time.time() + 240
        while not all(os.path.exists(f) for f in shards):
            if any(p.poll() is not None for p in procs):
                raise AssertionError("a worker exited before its checkpoint:"
                                     + procs[0].communicate()[0][-2000:])
            assert time.time() < deadline, "no checkpoint shards"
            time.sleep(0.2)
        procs[1].kill()                      # exact PID, never a pattern
        procs[1].wait(timeout=30)
        assert procs[1].returncode != 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()                     # the run is dead without rank 1
                p.wait(timeout=30)
    back = _finish(_start(frames_file, f"--ckpt={ck}", "--ckpt-at=7",
                          "--ckpt-load"))
    ref = {}
    for out in runs["plain"]:
        ref.update(_payloads(out))
    got = {}
    for out in back:
        assert "CKPT_LOADED" in out, out[-2000:]
        got.update(_payloads(out))
    assert got == ref, (got, ref)


def test_two_process_feat_axis_smoke():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "flame_ros_torch.parallel.dist_smoke",
         str(rank), "2", str(port), "--device", "cpu"], cwd=REPO,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    single = dist_smoke.single_coverage("cpu")
    torch.set_num_threads(1)
    outs = _finish(procs, marker="DIST_OK", key="pid")
    assert len(set(single)) == 1 and single[0] > 0.05, single
    for out in outs:
        line = [x for x in out.splitlines() if x.startswith("DIST_OK")][0]
        assert "mesh={'stream': 2, 'feat': 2}" in line, line
        assert float(line.split("cov=")[1]) == single[0], (line, single)


# --- stream groups on one process ----------------------------------------
H, W = 96, 128
TCAM = Pinhole(105.0, 105.0, 63.5, 47.5, W, H)
SMALL = {"engine": {"max_features": 256, "max_keyframes": 4},
         "input": {"poseframe_subsample_factor": 6}}


def test_stream_groups_equal_plain_runner(tmp_path):
    s = make_sequence(8, TCAM, motion="strafe", device="cpu")
    imgs = torch.clamp(s.images, 0, 255).to(torch.uint8).numpy()
    q, t, depths = s.poses.q, s.poses.t, s.depths.numpy()
    params = FlameParams.from_dict(SMALL)
    groups = MultiStreamRunner(TCAM, 2, params=params, mesh=["cpu", "cpu"])
    plain = MultiStreamRunner(TCAM, 2, params=params, device="cpu")
    assert [len(g) for g in groups.groups] == [1, 1] and not groups.spatial
    for i in range(8):
        ids = [i, max(i - 1, 0)]
        f = [(float(s.timestamps[k]), k, SE3(q[k], t[k]), imgs[k])
             for k in ids]
        gt = depths[ids]
        assert groups.update(f, gt_depths=gt) and plain.update(f,
                                                               gt_depths=gt)
        assert groups.flush_stats() == plain.flush_stats(), i
        for j, (a, b) in enumerate(zip(state_leaves(groups.states),
                                       state_leaves(plain.states))):
            assert torch.equal(a, b), (i, j)
    assert np.array_equal(groups.get_idepth_maps(), plain.get_idepth_maps(),
                          equal_nan=True)
    # CPU steps launch no kernel; the per-group counters exist.
    assert groups.group_launches == [0, 0]
    fn = groups.save_checkpoint(str(tmp_path / "groups"))
    back = MultiStreamRunner(TCAM, 2, params=params, device="cpu")
    back.load_checkpoint(fn)
    for a, b in zip(state_leaves(back.states), state_leaves(plain.states)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="split"):
        MultiStreamRunner(TCAM, 3, params=params, mesh=["cpu", "cpu"])
    # The layouts make_mesh builds, and "auto" on one device: the plain
    # path (the JAX rule takes gcd(S, devices) devices).
    cpu = torch.device("cpu")
    assert make_mesh(["cpu"] * 4, parts=2) == [[cpu, cpu], [cpu, cpu]]
    assert make_mesh(["cpu"] * 4, auto_for_streams=6) == [cpu, cpu]
    auto = MultiStreamRunner(TCAM, 2, params=params, mesh="auto",
                             device="cpu")
    assert auto.groups == [[cpu]] and not auto.spatial
