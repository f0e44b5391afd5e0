"""Ground rules of the PyTorch port (flame_ros_torch/):

- it imports nothing of JAX or of the JAX package, not even indirectly:
  a CPU run of the per-frame and the windowed, deferred paths, the mesh
  getters, the nodelet and the server, and tracking mode (the tracker,
  the ring relocalization, the pose graph and windowed bundle adjustment
  through `run_offline_tracking` with an occlusion, the stage profiler,
  the stress knobs, ATE/RPE), the many-stream runner on one device, on
  two stream groups and on two spatial parts, and the multi-process
  worker's module, leaves "jax" out of sys.modules
  (checked in a fresh interpreter, since the test process itself
  imports JAX), and no file of it (nor chip_smoke.py, nor the port's
  demo feeder and scripts) names either in an import;
- importing it turns TF32 off for matmul and cuDNN (the reference pins
  geometry to full f32);
- its entry points (the multi-process worker `parallel/dist_e2e.py`
  and the demo feeder `scripts/stream_synthetic_torch.py` among them)
  run on the card unless asked for the CPU, and raise
  rather than fall back to the CPU when there is no card.
"""
import ast
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

_RUN_3_FRAMES = """
import sys
import flame_ros_torch
from flame_ros_torch.config import FlameParams
from flame_ros_torch.datasets.synthetic import make_sequence
from flame_ros_torch.frontends.offline_runner import (run_offline,
                                                      run_offline_windowed,
                                                      synthetic_frames)
from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.models.engine import Flame
cam = Pinhole(105.0, 105.0, 63.5, 47.5, 128, 96)
params = FlameParams.from_dict({"engine": {"max_features": 128,
                                           "max_keyframes": 4}})
seq = make_sequence(3, cam, device="cpu")
res = run_offline(synthetic_frames(seq), cam, params, device="cpu")
assert res.frames_processed == 3, res
eng = Flame(128, 96, cam=cam, params=params, device="cpu",
            deferred_triangulation=True)
res = run_offline_windowed(synthetic_frames(seq), cam, params, window=3,
                           engine=eng)
assert res.frames_processed == 3, res
eng._apply_pending_triangulation(block=True)
eng.shutdown()
eng.get_inverse_depth_mesh()
eng.get_normal_map()
# The live frontend: the nodelet's threads, the server over 127.0.0.1.
import socket
import time
import numpy as np
from flame_ros_torch.frontends.nodelet import FlameNodelet
from flame_ros_torch.frontends.serve import FlameServer, recv_msg, send_msg
q, t = seq.poses.q.numpy(), seq.poses.t.numpy()
node = FlameNodelet(cam, params, device="cpu")
stats = []
node.on_stats.append(stats.append)
node.start()
for i in range(3):
    node.push_frame(i, float(seq.timestamps[i]), q[i], t[i], seq.images[i])
while len(stats) < 3:
    time.sleep(0.01)
node.stop()
srv = FlameServer(cam, params, device="cpu")
srv.start()
c = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
img = np.clip(seq.images[0].numpy(), 0, 255).astype(np.uint8)
send_msg(c, {"type": "frame", "img_id": 0, "time": 0.0,
             "quat": q[0].tolist(), "trans": t[0].tolist(),
             "shape": list(img.shape), "dtype": "uint8"}, img.tobytes())
assert recv_msg(c)[0]["type"] == "stats"
srv.stop()
c.close()
# Tracking mode: tracker, ring relocalization, pose graph, windowed BA,
# ATE/RPE.
import flame_ros_torch.models.ba
import flame_ros_torch.utils.stage_profiler
from flame_ros_torch.frontends.offline_runner import (run_offline_tracking,
                                                      with_occlusion)
tseq = make_sequence(8, cam, texture_gain=0.8, exposure_amp=0.1,
                     device="cpu")
tparams = FlameParams.from_dict({"engine": {"max_features": 256,
                                            "max_keyframes": 4},
                                 "input": {"poseframe_subsample_factor": 2},
                                 "pose_tracking": {"relocalize_after": 1,
                                                   "ba_anchor": "most_owned"},
                                 "debug": {"profile_stages": True,
                                           "profile_stages_every": 4}})
res = run_offline_tracking(with_occlusion(synthetic_frames(tseq), 5, 5),
                           cam, tparams, ba_refine=True, device="cpu")
assert res.track_failed_frames >= 1 and res.frames_processed >= 3, res
# Many streams, and the viz modules.
import flame_ros_torch.ops.colormap
import flame_ros_torch.viz.export
import flame_ros_torch.viz.html_viewer
import flame_ros_torch.viz.live_viewer
from flame_ros_torch.geometry.se3 import SE3
from flame_ros_torch.parallel.multi_stream import MultiStreamRunner
from flame_ros_torch.viz.debug_images import render_debug_images
runner = MultiStreamRunner(cam, 2, params=params, device="cpu",
                           deferred_triangulation=True)
for i in range(3):
    f = (0.0, i, SE3(seq.poses.q[i], seq.poses.t[i]), seq.images[i])
    assert runner.update([f, f])
runner.drain_topologies()
runner.shutdown()
assert len(runner.get_meshes()) == 2
# Device lists: two stream groups, and the spatial partition over two
# parts, on the CPU; the point-sharded BA and the multi-process worker.
import flame_ros_torch.parallel.dist_e2e
from flame_ros_torch.models.ba import hybrid_bundle_adjust_sharded
sparams = FlameParams.from_dict({"engine": {"max_features": 128,
                                            "max_keyframes": 4,
                                            "spatial_parts": 2}})
for mesh, p in ((["cpu", "cpu"], params), ([["cpu", "cpu"]], sparams)):
    runner = MultiStreamRunner(cam, 2, params=p, mesh=mesh)
    for i in range(3):
        f = (0.0, i, SE3(seq.poses.q[i], seq.poses.t[i]), seq.images[i])
        assert runner.update([f, f])
    assert len(runner.get_meshes()) == 2
assert render_debug_images(eng, seq.images[2].numpy())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flame_ros_tpu"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_cpu_run_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _RUN_3_FRAMES], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_tf32_off_after_import():
    import flame_ros_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from flame_ros_torch.datasets.synthetic import QVGA, make_sequence
    from flame_ros_torch.frontends.offline_runner import main, run_offline
    from flame_ros_torch.models.engine import Flame
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Flame(QVGA.width, QVGA.height, cam=QVGA)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_sequence(2, QVGA)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_offline([], QVGA, __import__(
            "flame_ros_torch.config", fromlist=["FlameParams"]).FlameParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--dataset", "synthetic", "--frames", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--dataset", "tum", "--input", "assoc.txt"])
    spec = importlib.util.spec_from_file_location(
        "stream_synthetic_torch",
        os.path.join(REPO, "scripts", "stream_synthetic_torch.py"))
    feeder = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(feeder)
    with pytest.raises(RuntimeError, match="CUDA"):
        feeder.main(["--port", "0", "--frames", "2"])
    from flame_ros_torch.frontends.nodelet import FlameNodelet
    from flame_ros_torch.frontends.serve import FlameServer
    with pytest.raises(RuntimeError, match="CUDA"):
        FlameNodelet(QVGA)
    with pytest.raises(RuntimeError, match="CUDA"):
        FlameServer(QVGA)
    with pytest.raises(RuntimeError, match="CUDA"):
        FlameNodelet(QVGA, pose_source="tracking")
    with pytest.raises(RuntimeError, match="CUDA"):
        FlameServer(QVGA, pose_source="tracking")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--dataset", "synthetic", "--frames", "2",
              "--pose-source", "tracking"])
    with pytest.raises(RuntimeError, match="CUDA"):
        FlameNodelet(QVGA, pose_source="tracking", ba_refine=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--dataset", "synthetic", "--frames", "2",
              "--pose-source", "tracking", "--ba-refine"])
    from flame_ros_torch.parallel.multi_stream import MultiStreamRunner
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiStreamRunner(QVGA, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiStreamRunner(QVGA, 2, mesh=["cuda:0", "cuda:0"])
    from flame_ros_torch.frontends.nodelet import main as nodelet_main
    with pytest.raises(RuntimeError, match="CUDA"):
        nodelet_main(["--fx", "262.5", "--fy", "262.5", "--cx", "159.5",
                      "--cy", "119.5", "--width", "320", "--height", "240",
                      "--port", "0"])
    from flame_ros_torch.parallel import dist_e2e
    with pytest.raises(RuntimeError, match="CUDA"):
        dist_e2e.cli(["0", "2", "29500", "13"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dist_e2e.cli(["0", "2", "29500", "13", "--spatial"])
    # Explicit CPU works.
    assert Flame(QVGA.width, QVGA.height, cam=QVGA,
                 device="cpu").device.type == "cpu"


def _sources():
    pkg = os.path.join(REPO, "flame_ros_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    for script in ("stream_synthetic_torch.py", "chip_acc_streaming_torch.py",
                   "torch_profile.py"):
        yield os.path.join(REPO, "scripts", script)


def test_no_jax_imports_in_port():
    """No file of the port, not chip_smoke.py and not the port's scripts
    (the demo feeder, the streaming acceptance protocol, the profiler)
    has an import statement naming jax, jaxlib or flame_ros_tpu;
    the port's demo scripts name neither package."""
    for sh in ("demo_torch.sh", "demo_live_torch.sh"):
        with open(os.path.join(REPO, "scripts", sh)) as f:
            text = f.read()
        assert "flame_ros_tpu" not in text and "jax" not in text, sh
    for path in sorted(_sources()):
        rel = os.path.relpath(path, REPO)
        with open(path) as f:
            tree = ast.parse(f.read(), rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "flame_ros_tpu"), \
                    f"{rel}:{node.lineno} imports {n}"
