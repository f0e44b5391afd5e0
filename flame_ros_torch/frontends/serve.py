"""Network streaming server: posed frames in, depth products out.

Counterpart of `flame_ros_tpu/frontends/serve.py`, with the same wire
format, so a client of one talks to the other:

    message   := u32_le length | JSON header | raw payload (header.nbytes)
    client -> {"type": "frame", "img_id", "time", "quat", "trans",
               "shape": [H, W], "dtype": "uint8", "nbytes": H*W}
              {"type": "poseframes", "ids": [...], "poses": [[q4 t3]...]}
              {"type": "get_mesh"} | {"type": "get_idepth"} | {"type": "stop"}
    server -> per processed frame: {"type": "stats", ...telemetry...}
              for get_mesh: header + NPZ payload (with K)
              for get_idepth: header + float32 payload

The server wraps one FlameNodelet whose engine runs on `device`. With
`pose_source="tracking"` (`--pose-source tracking`) the nodelet estimates
the poses and a client sends frames without "quat"/"trans". Beside the
JAX package's server: an error of any kind ends only the connection it
came from (and is logged); `stop()` closes the live
connections; the warmup builds the raster kernel library, the native
Delaunay library and the CUDA context and makes no second engine.
"""
from __future__ import annotations

import io
import json
import logging
import socket
import struct
import threading
from typing import Optional

import numpy as np
import torch

from flame_ros_torch.config import FlameParams
from flame_ros_torch.frontends.nodelet import FlameNodelet
from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.geometry.se3 import SE3

_log = logging.getLogger(__name__)


def send_msg(sock: socket.socket, header: dict, payload: bytes = b""):
    header = dict(header)
    if payload:
        header["nbytes"] = len(payload)
    blob = json.dumps(header).encode()
    sock.sendall(struct.pack("<I", len(blob)) + blob + payload)


def recv_msg(sock: socket.socket):
    raw = _recv_exact(sock, 4)
    if raw is None:
        return None, b""
    (n,) = struct.unpack("<I", raw)
    blob = _recv_exact(sock, n)
    if blob is None:
        return None, b""
    header = json.loads(blob)
    payload = b""
    if header.get("nbytes"):
        payload = _recv_exact(sock, header["nbytes"]) or b""
    return header, payload


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class FlameServer:
    def __init__(self, cam: Pinhole, params: Optional[FlameParams] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 queue_size: int = 8, device=None,
                 pose_source: str = "external"):
        self.node = FlameNodelet(cam, params, queue_size=queue_size,
                                 pose_source=pose_source, device=device)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Serializes engine product reads (get_mesh/get_idepth) across
        # concurrent client connections.
        self._products_lock = threading.Lock()
        # Live connections and their threads, closed and joined by stop().
        self._conns: dict[socket.socket, threading.Thread] = {}
        self._conns_lock = threading.Lock()

    def start(self, warmup: bool = True):
        if warmup:
            self._warmup()
        self.node.start()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _warmup(self):
        """Build what the first frame would otherwise wait for, before
        serving: the native Delaunay library, and on the card the CUDA
        context and the raster kernel library. Until then clients wait in
        the listen backlog (TCP backpressure) instead of losing frames to
        the drop-newest queue. The serving engine's state is untouched."""
        from flame_ros_torch.graph.delaunay import native_available
        native_available()
        dev = self.node.engine.device
        if dev.type == "cuda":
            from flame_ros_torch.ops import raster_cuda
            torch.zeros(1, device=dev)
            raster_cuda._get_lib()
            torch.cuda.synchronize(dev)

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        # shutdown() wakes an accept() blocked in another thread; close()
        # alone does not on Linux.
        for end in (lambda: self._srv.shutdown(socket.SHUT_RDWR),
                    self._srv.close):
            try:
                end()
            except OSError:
                pass
        with self._conns_lock:
            live = list(self._conns.items())
        for conn, _ in live:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for _, th in live:
            th.join(timeout)
        if self._thread is not None:
            self._thread.join(timeout)
        self.node.stop(timeout)

    def _accept_loop(self):
        # One thread per connection (a frame streamer and a mesh poller
        # at least); a connection's errors stay in its thread.
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            th = threading.Thread(target=self._run_conn, args=(conn,),
                                  daemon=True)
            with self._conns_lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns[conn] = th
            th.start()

    def _run_conn(self, conn: socket.socket):
        try:
            self._serve_conn(conn)
        except OSError:
            pass        # the client went away (reset, broken pipe)
        except Exception:
            # A malformed message or a failure in the engine ends this
            # connection only; the server goes on.
            _log.exception("flame-serve: connection ended by an error")
        finally:
            with self._conns_lock:
                self._conns.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_conn(self, conn: socket.socket):
        lock = threading.Lock()

        def on_stats(rec):
            try:
                with lock:
                    send_msg(conn, {"type": "stats", **{
                        k: (float(v) if isinstance(
                            v, (int, float, np.floating)) else v)
                        for k, v in rec.items()
                        if not isinstance(v, np.ndarray)}})
            except OSError:
                pass

        self.node.on_stats.append(on_stats)
        try:
            while not self._stop.is_set():
                header, payload = recv_msg(conn)
                if header is None or header.get("type") == "stop":
                    return
                t = header["type"]
                if t == "frame":
                    img = np.frombuffer(
                        payload, dtype=header.get("dtype", "uint8")
                    ).reshape(header["shape"]).astype(np.float32)
                    self.node.push_frame(
                        header["img_id"], header["time"],
                        header.get("quat"), header.get("trans"), img)
                elif t == "poseframes":
                    poses = np.asarray(header["poses"], np.float32)
                    self.node.poseframe_callback(
                        header["ids"], SE3(torch.from_numpy(poses[:, :4]),
                                           torch.from_numpy(poses[:, 4:7])))
                elif t == "get_mesh":
                    with self._products_lock:
                        uv, x, normals, tris, keep, edges = \
                            self.node.engine.get_inverse_depth_mesh()
                    buf = io.BytesIO()
                    # K rides along so a remote viewer can backproject
                    # without out-of-band calibration.
                    np.savez(buf, vertices_px=uv, idepths=x,
                             normals=normals, triangles=tris,
                             tri_validity=keep, edges=edges,
                             K=self.node.cam.K)
                    with lock:
                        send_msg(conn, {"type": "mesh"}, buf.getvalue())
                elif t == "get_idepth":
                    with self._products_lock:
                        m = self.node.engine.get_inverse_depth_map()
                    with lock:
                        send_msg(conn, {"type": "idepth",
                                        "shape": list(m.shape)},
                                 np.ascontiguousarray(m, np.float32)
                                 .tobytes())
        finally:
            self.node.on_stats.remove(on_stats)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7447)
    p.add_argument("--fx", type=float, required=True)
    p.add_argument("--fy", type=float, required=True)
    p.add_argument("--cx", type=float, required=True)
    p.add_argument("--cy", type=float, required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--config")
    p.add_argument("--queue-size", type=int, default=8,
                   help="frames the server may hold before it drops "
                        "(drop-newest)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--pose-source", default="external",
                   choices=["external", "tracking"],
                   help="tracking: estimate poses online (direct tracker "
                        "+ pose graph); clients send frames without poses")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip building the kernel libraries before "
                        "serving (frames arriving during the build may "
                        "then drop)")
    args = p.parse_args(argv)
    cam = Pinhole(args.fx, args.fy, args.cx, args.cy, args.width,
                  args.height)
    params = (FlameParams.from_yaml(args.config) if args.config
              else FlameParams())
    srv = FlameServer(cam, params, host=args.host, port=args.port,
                      queue_size=args.queue_size, device=args.device,
                      pose_source=args.pose_source)
    srv.start(warmup=not args.no_warmup)
    print(f"flame-serve listening on {args.host}:{srv.port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":   # `python -m flame_ros_torch.frontends.serve`
    main()
