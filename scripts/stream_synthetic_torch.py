"""Stream a synthetic posed sequence into a running FlameServer over its
TCP protocol: the feeder of the live-viewer demo (scripts/
demo_live_torch.sh). The sequence is rendered by the PyTorch port's
renderer on `--device` (the card unless asked for the CPU) and sent as
uint8 frames; no dataset download.

    python scripts/stream_synthetic_torch.py --port 7447 --frames 200 \
        --rate 10 [--resolution vga] [--device cpu]
"""
import argparse
import os
import socket
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from flame_ros_torch.datasets.synthetic import QVGA, VGA, make_sequence  # noqa: E402,E501
from flame_ros_torch.frontends.serve import send_msg  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7447)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--rate", type=float, default=10.0,
                   help="frames/s to stream (0 = as fast as possible)")
    p.add_argument("--resolution", default="qvga", choices=["qvga", "vga"])
    p.add_argument("--device", default="cuda",
                   help="torch device the sequence renders on")
    args = p.parse_args(argv)
    cam = VGA if args.resolution == "vga" else QVGA
    seq = make_sequence(n_frames=args.frames, cam=cam, device=args.device)
    imgs = torch.clamp(seq.images, 0, 255).to(torch.uint8).cpu().numpy()
    q, t = seq.poses.q.cpu().numpy(), seq.poses.t.cpu().numpy()
    c = socket.create_connection((args.host, args.port))
    try:
        for i in range(args.frames):
            send_msg(c, {"type": "frame", "img_id": i,
                         "time": float(seq.timestamps[i]),
                         "quat": q[i].tolist(), "trans": t[i].tolist(),
                         "shape": [cam.height, cam.width],
                         "dtype": "uint8"}, np.ascontiguousarray(
                             imgs[i]).tobytes())
            if args.rate > 0:
                time.sleep(1.0 / args.rate)
        print(f"streamed {args.frames} frames")
    finally:
        send_msg(c, {"type": "stop"})
        c.close()


if __name__ == "__main__":
    main()
