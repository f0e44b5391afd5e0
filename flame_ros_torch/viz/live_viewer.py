"""Live streaming mesh viewer.

Counterpart of `flame_ros_tpu/viz/live_viewer.py`, polling the port's
`frontends.serve.FlameServer` (the same wire protocol).

The reference renders the mesh CONTINUOUSLY while the system runs — the
rviz TexturedMeshDisplay consumes a mesh topic and re-uploads GPU
buffers per message (textured_mesh_display.cc:389-503). This module
reproduces that UX without rviz: it polls a running
`frontends.serve.FlameServer` over its TCP protocol (`get_mesh`) and
serves the existing WebGL viewer page (viz/html_viewer.py) with an
auto-refresh loop, so a browser shows the mesh GROWING while the engine
streams.

    # terminal 1: the engine server (frontends/serve.py)
    flame-serve-torch --fx ... --width 640 --height 480
    # terminal 2: the live viewer
    python -m flame_ros_torch.viz.live_viewer --server-port 7447
    # browser: http://127.0.0.1:8047

One poller thread owns the TCP connection (stats pushes from the server
interleave with mesh replies — the poller drains and keeps the latest
telemetry), one ThreadingHTTPServer serves `/` (the page) and
`/mesh.json` (the latest backprojected buffers, stamped so the page
only re-uploads on change).
"""
from __future__ import annotations

import io
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from flame_ros_torch.frontends.serve import recv_msg, send_msg
from flame_ros_torch.viz.html_viewer import mesh_viewer_data, render_page


class LiveMeshViewer:
    def __init__(self, server_host: str = "127.0.0.1",
                 server_port: int = 7447,
                 http_host: str = "127.0.0.1", http_port: int = 8047,
                 period_s: float = 0.5):
        self.server_addr = (server_host, server_port)
        self.http_host = http_host
        self.http_port = http_port
        self.period_s = period_s
        self._latest: dict | None = None   # viewer-data JSON + stamp
        self._latest_lock = threading.Lock()
        self._stamp = 0
        self._img_id = -1
        self._stop = threading.Event()
        self._httpd: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []

    # -- poller ----------------------------------------------------------
    def _poll_loop(self):
        sock = None
        while not self._stop.is_set():
            try:
                if sock is None:
                    sock = socket.create_connection(self.server_addr,
                                                    timeout=5.0)
                    sock.settimeout(10.0)
                send_msg(sock, {"type": "get_mesh"})
                # The server pushes per-frame stats on the same
                # connection; drain until the mesh reply arrives.
                while True:
                    header, payload = recv_msg(sock)
                    if header is None:
                        raise OSError("server closed")
                    if header.get("type") == "stats":
                        self._img_id = int(header.get("img_id",
                                                      self._img_id))
                        continue
                    if header.get("type") == "mesh":
                        break
                data = np.load(io.BytesIO(payload))
                if data["vertices_px"].shape[0] >= 3 and "K" in data:
                    d = mesh_viewer_data(
                        data["vertices_px"], data["idepths"],
                        data["normals"], data["triangles"],
                        data["tri_validity"], data["K"])
                    self._stamp += 1
                    d["stamp"] = self._stamp
                    d["img_id"] = self._img_id
                    with self._latest_lock:
                        self._latest = d
            except (OSError, socket.timeout):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
            self._stop.wait(self.period_s)
        if sock is not None:
            try:
                send_msg(sock, {"type": "stop"})
                sock.close()
            except OSError:
                pass

    # -- http ------------------------------------------------------------
    def _make_handler(viewer):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/mesh.json"):
                    with viewer._latest_lock:
                        d = viewer._latest
                    if d is None:
                        self.send_response(204)   # nothing yet
                        self.end_headers()
                        return
                    blob = json.dumps(d).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(blob)))
                    self.end_headers()
                    self.wfile.write(blob)
                    return
                with viewer._latest_lock:
                    d = viewer._latest
                empty = {"xyz": [], "normals": [], "uv": [], "tris": [],
                         "center": [0, 0, 1], "scale": 1.0,
                         "texture_png": None}
                page = render_page(
                    d or empty,
                    live_period_ms=int(viewer.period_s * 1000)).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)

        return Handler

    # -- lifecycle -------------------------------------------------------
    def start(self):
        self._httpd = ThreadingHTTPServer(
            (self.http_host, self.http_port), self._make_handler())
        self.http_port = self._httpd.server_port
        t1 = threading.Thread(target=self._poll_loop, daemon=True)
        t2 = threading.Thread(target=self._httpd.serve_forever,
                              daemon=True)
        t1.start()
        t2.start()
        self._threads = [t1, t2]
        return self

    def stop(self):
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=5.0)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--server-host", default="127.0.0.1")
    p.add_argument("--server-port", type=int, default=7447)
    p.add_argument("--http-host", default="127.0.0.1")
    p.add_argument("--http-port", type=int, default=8047)
    p.add_argument("--period", type=float, default=0.5,
                   help="mesh poll period in seconds")
    args = p.parse_args(argv)
    viewer = LiveMeshViewer(args.server_host, args.server_port,
                            args.http_host, args.http_port,
                            period_s=args.period).start()
    print(f"live mesh viewer at http://{viewer.http_host}:"
          f"{viewer.http_port} (polling {args.server_host}:"
          f"{args.server_port} every {args.period}s)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        viewer.stop()


if __name__ == "__main__":
    main()
