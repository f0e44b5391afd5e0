"""External-pose acceptance gates of the port, the easy regime and the
dataset pipelines: the runs of tests/test_acceptance.py (default) and
tests/test_acceptance_stress.py (exposure A/B, tum, asl) through the
port's `offline_runner.main` at VGA over 200 frames with the default
FlameParams (`chip_smoke.acceptance_run`). Each run is held to the JAX
package's run of the same frames, `chip_smoke.JAX_ACCEPT_VGA200`
(`chip_smoke.accept_verdict`): rmse, recall and coverage within
JAX_BAND; each of the JAX file's gates that the JAX run passes, passed
(the ones it fails, its known coverage floors, are held to the JAX run
by the band); exposure B beating A wherever JAX's does. Every run also:
200 frames, none failed, every frame healthy, the id buffer of frame 97
and of poseframe 150 (after the third ring wrap) equal to the plain v4
version's recomputation from the engine's state and to the plain
formulation up to evaluation-order splits; on the card, v4 launched on
every frame and v2 and v3 never, and every frame the run read equal bit
for bit to the CPU's rendering of it, which the JAX run read
(`chip_smoke.frame_digest`).

Slow (minutes each on the CPU): left out of the tier-1 run. They run on
the card where one exists, else on the CPU:

    python -m pytest tests/test_torch_acceptance.py -m slow -q -s

One tier-1 case, with no JAX compile: `chip_smoke.TRACK_ACCEPT_RUNS`
(the tracking protocol of phase 15 and
tests/test_torch_acceptance_tracking.py) holds the runner arguments and
the asserts of tests/test_acceptance_tracking.py, read with `ast`, and
cfg/pod_dense_ba.yaml loads to the same values in both packages.
"""
import ast
import dataclasses
import json
import os

import pytest
import torch

import chip_smoke

# One intra-op thread at import, as every port test file: the tier-1
# run imports this file in its workers. A run on the CPU takes the cores.
torch.set_num_threads(1)


def _check(name, out, other=None):
    device = "cuda" if torch.cuda.is_available() else "cpu"
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        r = chip_smoke.acceptance_run(name, device, str(out))
        differ = {}
        if device == "cuda":
            from flame_ros_torch.datasets.synthetic import VGA, make_sequence
            differ = chip_smoke.frames_differ(
                r["digests"], chip_smoke.sequence_digests(make_sequence(
                    chip_smoke.ACCEPT_FRAMES, VGA, device="cpu",
                    **chip_smoke.accept_sequence(name))))
    finally:
        torch.set_num_threads(threads)
    if other is not None:
        other = (other["summary"], chip_smoke.JAX_ACCEPT_VGA200[
            "exposure_a"])
    verdict, ok = chip_smoke.accept_verdict(
        name, r["summary"], chip_smoke.JAX_ACCEPT_VGA200[name], other)
    print(json.dumps({"device": device, "run": name, "ok": ok,
                      "summary": r["summary"], "verdict": verdict,
                      "ms_per_frame_p50": r["ms_per_frame_p50"],
                      "launches": r["launches"], "checks": r["checks"],
                      "frames_differ_from_cpu": differ}))
    assert ok, verdict
    assert not any(differ.values()), differ
    return r


@pytest.mark.slow
def test_default_vga200(tmp_path):
    _check("default", tmp_path)


@pytest.mark.slow
def test_exposure_zero_mean_ssd_ab_vga200(tmp_path):
    a = _check("exposure_a", tmp_path)
    _check("exposure_b", tmp_path, other=a)


@pytest.mark.slow
def test_tum_pipeline_vga200(tmp_path):
    _check("tum", tmp_path)


@pytest.mark.slow
def test_asl_pipeline_mav_vga200(tmp_path):
    _check("asl", tmp_path)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _const(node):
    """The value of a constant expression (numbers, + and -)."""
    return eval(compile(ast.Expression(node), "<gate>", "eval"), {})


def _key(node):
    """"k" of s["k"], else None."""
    if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
            and node.value.id == "s"):
        return node.slice.value
    return None


_FLIP = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "==": "=="}
_OPS = {ast.Lt: "<", ast.Gt: ">", ast.LtE: "<=", ast.GtE: ">=",
        ast.Eq: "=="}


def _gates(fn):
    """The asserts of a JAX tracking test as gates (key, op, bound), bound
    a number or (f, key) for f * s[key]; and its spy facts."""
    gates, spy = [], {}
    for a in (n for n in ast.walk(fn) if isinstance(n, ast.Assert)):
        tests = (a.test.values if isinstance(a.test, ast.BoolOp)
                 else [a.test])
        for t in tests:
            if isinstance(t, ast.Call) and t.func.id == "all":
                spy["ba_points"] = _const(t.args[0].elt.comparators[0])
                continue
            terms = [t.left] + t.comparators
            for (x, y), op in zip(zip(terms, terms[1:]), t.ops):
                op = _OPS[type(op)]
                if isinstance(x, ast.Call) and x.func.id == "len":
                    spy["solves_min"] = _const(y)
                elif _key(x) is not None:
                    if isinstance(y, ast.BinOp) and _key(y.right):
                        gates.append((_key(x), op, (_const(y.left),
                                                    _key(y.right))))
                    else:
                        gates.append((_key(x), op, _const(y)))
                else:
                    gates.append((_key(y), _FLIP[op], _const(x)))
    return gates, spy


def test_track_accept_runs_are_the_jax_file():
    import chip_smoke
    from flame_ros_torch.config import FlameParams as TParams
    from flame_ros_tpu.config import FlameParams as JParams
    tree = ast.parse(open(os.path.join(
        REPO, "tests", "test_acceptance_tracking.py")).read())
    fns = {n.lineno: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    run = next(n for n in fns.values() if n.name == "_run")
    base = [_const(e) for e in next(
        c for c in ast.walk(run) if isinstance(c, ast.Call)
        and getattr(c.func, "id", "") == "main").args[0].elts if
        not isinstance(e, ast.Starred)]
    tests = {n.name for n in fns.values() if n.name.startswith("test_")}
    seen = set()
    for name, spec in chip_smoke.TRACK_ACCEPT_RUNS.items():
        path, line = spec["test"].split(":")
        assert path == "tests/test_acceptance_tracking.py"
        fn = fns[int(line)]
        seen.add(fn.name)
        extra = [_const(e) for e in next(
            c for c in ast.walk(fn) if isinstance(c, ast.Call)
            and getattr(c.func, "id", "") == "_run").args[1:]]
        flags = []
        for k, v in spec["seq"].items():
            flags += ["--" + k.replace("_", "-"), str(v)]
        assert base + extra == (chip_smoke.track_argv(name)[:len(base)]
                                + flags + list(spec["args"])), name
        gates, spy = _gates(fn)
        assert gates == list(spec["gates"]), (name, gates)
        assert spy == {k: spec[k] for k in ("solves_min", "ba_points")
                       if k in spec}, (name, spy)
        assert chip_smoke.track_sequence(name) == chip_smoke.accept_sequence(
            "default") | spec["seq"]
    assert seen == tests
    # The pod-dense configuration loads alike in both packages.
    yaml = os.path.join(REPO, "cfg", "pod_dense_ba.yaml")
    j = dataclasses.asdict(JParams.from_yaml(yaml))
    t = TParams.from_yaml(yaml)
    assert dataclasses.asdict(t) == j
    assert (t.engine.max_features, t.engine.max_triangles,
            t.pose_tracking.ba_budget) == (16384, 32768, 16384)
