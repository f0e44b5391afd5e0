"""The benchmark of `flame_ros_torch` on NVIDIA cards (BENCHMARK.json at
the repository root; `python3 -m flamebench.run`)."""
