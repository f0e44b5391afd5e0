"""BENCHMARK.json against the benchmark's contract, and every
configuration, traffic mix and metric it names found by name."""
import json
import os
import re

import numpy as np
import pytest

from flamebench import harness, manifest, traffic

M = manifest.Manifest()
D = M.data
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = [m["name"] for m in D["end_to_end"]]


def test_top_level_keys():
    assert list(D) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert D["paths"] == ["flamebench"]
    assert 1 <= D["run_seconds"] <= 51
    assert len(json.dumps(D)) <= 64 * 1024
    # The command names no file outside paths.
    assert D["command"] == ["python3", "-m", "flamebench.run"]


@pytest.mark.parametrize("c", D["configs"], ids=lambda c: c["name"])
def test_config_resolves(c):
    assert NAME.match(c["name"])
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("flamebench/configs/")
    cfg = M.config(c["name"])
    assert cfg["reduced"] == c["reduced"]
    assert {"camera", "params", "dtype", "source"} <= set(cfg)
    assert any(w["config"] == c["name"] for w in D["workloads"])
    from flame_ros_torch.config import FlameParams
    FlameParams.from_dict(cfg["params"])       # every key known


@pytest.mark.parametrize("w", D["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    assert NAME.match(w["name"]) and w["chips"] in (1, 4)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert 1 <= len(w["why"]) <= 200
    M.config(w["config"])
    mix = traffic.load_mix(M.mix_path(w["traffic"]))
    assert mix["streams"] >= mix["check_streams"] >= 1
    drv = harness.driver(mix["driver"])
    assert set(drv.MIX_KEYS) <= set(mix)
    assert callable(drv.replay) and callable(drv.check_streams)


@pytest.mark.parametrize("m", D["end_to_end"] + D["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(manifest.reader(m["name"]))
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in E2E and m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in D[key]]
        assert len(names) == len(set(names))
    names = E2E + [m["name"] for m in D["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in E2E
    pairs = [(w["config"], w["traffic"]) for w in D["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_paths_hold_only_the_benchmark():
    root = os.path.join(M.root, "flamebench")
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, M.root)
        for f in files:
            assert re.match(r"^[A-Za-z0-9_./-]+$", os.path.join(rel, f))


@pytest.mark.parametrize("w", D["workloads"], ids=lambda w: w["name"])
def test_pool_shows_new_views(w):
    """Every step of a window at up to twice the mix's rate shows a pose
    of its own: the path runs forward through the whole pool, and frame p
    is the same whatever the pool's length."""
    mix = traffic.load_mix(M.mix_path(w["traffic"]))
    P = traffic.pool_frames(mix, D["run_seconds"])
    assert P >= (mix["warmup_updates"]
                 + 2 * mix["steps_per_s"] * D["run_seconds"])
    assert [traffic.pool_index(k, P) for k in range(P)] == list(range(P))
    q, t = traffic.trajectories(mix, 6_000_000_001, P)
    pose = np.concatenate([q, t], -1)
    step = np.linalg.norm(np.diff(pose, axis=1), axis=-1)
    assert step.min() > 1e-4
    q2, t2 = traffic.trajectories(mix, 6_000_000_001, 40)
    assert np.array_equal(t2, t[:, :40]) and np.array_equal(q2, q[:, :40])
