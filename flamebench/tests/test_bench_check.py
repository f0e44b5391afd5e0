"""The comparison that decides `correct`, on a tiny cell on the CPU: the
plain reference replays the port's CPU runner exactly; the bfloat16
control and each fault the cells can have, planted under the harness,
make `correct` come out false; the result line has the contract's
shape."""
import json

import pytest
import torch

from flamebench import manifest, run

E2E = [m for m in manifest.Manifest().data["end_to_end"]]
SEED = 3_000_000_017


def _run(tiny, override=None, seed=SEED):
    cfg, mix = tiny
    return run.run(cfg, mix, seed, 0.0, "cpu", E2E, override=override)


def test_reference_replays_the_port(tiny):
    out, info = _run(tiny)
    assert out["correct"], out["check"]
    assert all(v["value"] == 0 for v in out["check"].values()), out["check"]
    assert info["steps"] == tiny[1]["warmup_updates"] + 1


def test_result_line_shape(tiny):
    out, _ = _run(tiny)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert out["attempted"] == tiny[1]["streams"] and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in E2E}
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in out["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(out)


def test_control_fails(tiny):
    """The program's own lower-precision path (bfloat16 gathers). The
    images are integers, exact in bfloat16, so only the coarser pyramid
    levels round; at this tiny size that moves the filter on some seeds
    only (seed 2: one stream's means by 0.4), while every cell's control
    run on the card fails by far (PERF.md §2)."""
    out, _ = _run(tiny, override=run.CONTROLS["bf16"], seed=2)
    assert not out["correct"], out["check"]


def test_deferred_blocking_rounds_replay(tiny):
    """A mix may ask the runner for deferred rounds with blocking installs
    (data only): they keep the reference's schedule, so the reference
    replays them exactly too."""
    cfg, mix = tiny
    mix = dict(mix, runner={"deferred_triangulation": True,
                            "blocking_installs": True})
    out, _ = run.run(cfg, mix, SEED, 0.0, "cpu", E2E)
    assert all(v["value"] == 0 for v in out["check"].values()), out["check"]


@pytest.mark.parametrize("runner", [{"deferred_triangulation": True},
                                    {"prefetch": 2}],
                         ids=["no_fixed_schedule", "unknown_option"])
def test_mix_without_a_reference_is_refused(tiny, runner):
    cfg, mix = tiny
    with pytest.raises(ValueError):
        run.run(cfg, dict(mix, runner=runner), SEED, 0.0, "cpu", E2E)


def _state_unchanged(orig):
    def step(states, *a, **kw):
        _, dmap, row = orig(states, *a, **kw)
        return states, dmap, row
    return step


def _half_batch(orig):
    def step(states, *a, **kw):
        st, dmap, row = orig(states, *a, **kw)
        h = row.shape[0] // 2
        leaves = [torch.cat([new[:h], old[h:]]) for new, old in
                  zip(_leaves(st), _leaves(states))]
        row = torch.cat([row[:h], row[:h].mean(0, keepdim=True).expand(
            row.shape[0] - h, -1)])
        return _from_leaves(leaves), dmap, row
    return step


def _answer_altered(orig):
    def step(states, *a, **kw):
        st, dmap, row = orig(states, *a, **kw)
        from flame_ros_torch.models.engine import DEVICE_STATS_KEYS
        k = DEVICE_STATS_KEYS.index("coverage")
        row = row.clone()
        row[:, k] += 0.01
        return st, dmap, row
    return step


def _leaves(st):
    from flame_ros_torch.models.engine import state_leaves
    return state_leaves(st)


def _from_leaves(leaves):
    from flame_ros_torch.models.engine import state_from_leaves
    return state_from_leaves(leaves)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_fault_fails(tiny, monkeypatch, fault):
    from flame_ros_torch.parallel import multi_stream
    monkeypatch.setattr(multi_stream, "batched_full_step",
                        fault(multi_stream.batched_full_step))
    out, _ = _run(tiny)
    assert not out["correct"], out["check"]


@pytest.mark.cuda
def test_cell_on_the_card():
    """A short run of the first cell on the card: correct, with every
    end-to-end metric (run on the chip with -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from flamebench import traffic
    m = manifest.Manifest()
    w = m.data["workloads"][0]
    out, _ = run.run(m.config(w["config"]),
                     traffic.load_mix(m.mix_path(w["traffic"])), 5, 3.0,
                     torch.device("cuda", 0), m.data["end_to_end"])
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {x["name"] for x in m.data["end_to_end"]}
