"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's)."""
import os
import subprocess
import sys

from flamebench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_whole_word_match(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "flame_ros_torch_x",
                        types.ModuleType("flame_ros_torch_x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like",
                        types.ModuleType("jaxtyping_like"))
    assert "flame_ros_torch_x" not in run.forbidden_modules()
    assert "jaxtyping_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flame_ros_tpu.config",
                        types.ModuleType("flame_ros_tpu.config"))
    assert run.forbidden_modules() == ["flame_ros_tpu"]


def test_benchmark_loads_no_jax():
    """Every module of flamebench, the metric readers and the reference,
    imported in a fresh process."""
    code = (
        "import glob, os, sys, importlib\n"
        "from flamebench import manifest\n"
        "for p in sorted(glob.glob('flamebench/**/*.py', recursive=True)):\n"
        "    if '/tests/' in p or p.endswith('__main__.py'):\n"
        "        continue\n"
        "    if '/metrics/' in p:\n"
        "        manifest.reader(os.path.basename(p)[:-3])\n"
        "    else:\n"
        "        importlib.import_module(p[:-3].replace('/', '.')"
        ".removesuffix('.__init__'))\n"
        "import flame_ros_torch.parallel.multi_stream\n"
        "from flamebench.run import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
