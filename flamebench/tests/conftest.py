"""Shared pieces of the benchmark's CPU tests: a tiny cell (a 128 x 160
camera, 256 feature slots, 4 keyframes, 2-4 streams) that runs the
harness end to end on the CPU in seconds."""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def tiny():
    """(config, mix) of a tiny cell built from tum_vga and fleet8: the
    mix's warm-up covers every step a test drives, so a zero-second
    window adds exactly one step."""
    import torch
    from flamebench import traffic
    from flamebench.harness import merge
    torch.set_num_threads(1)
    with open(os.path.join(ROOT, "flamebench", "configs",
                           "tum_vga.json")) as f:
        cfg = json.load(f)
    cfg["camera"] = dict(cfg["camera"], fx=133.85, fy=134.8, cx=80.0,
                         cy=62.0, width=160, height=128)
    cfg["params"] = merge(cfg["params"], {
        "engine": {"max_features": 256, "max_keyframes": 4}})
    mix = traffic.load_mix(os.path.join(ROOT, "flamebench", "traffic",
                                        "fleet8.json"))
    mix.update(streams=4, warmup_updates=35,
               check_streams=4)
    return cfg, mix
