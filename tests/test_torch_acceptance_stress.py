"""External-pose acceptance gates of the port, the stress regimes: the
runs of tests/test_acceptance_stress.py (rotation, low texture, both at
once, 6-DoF MAV motion, the primitives scene) through the port's
`offline_runner.main` at VGA over 200 frames with the default
FlameParams, held to the JAX package's runs of the same frames
(`chip_smoke.JAX_ACCEPT_VGA200`) with the checks of
tests/test_torch_acceptance.py (`chip_smoke.acceptance_run` and
`chip_smoke.accept_verdict`).

Slow (minutes each on the CPU): left out of the tier-1 run. They run on
the card where one exists, else on the CPU:

    python -m pytest tests/test_torch_acceptance_stress.py -m slow -q -s
"""
import pytest

from test_torch_acceptance import _check


@pytest.mark.slow
def test_rotation_stress_vga200(tmp_path):
    _check("rotation", tmp_path)


@pytest.mark.slow
def test_low_texture_stress_vga200(tmp_path):
    _check("low_texture", tmp_path)


@pytest.mark.slow
def test_rotation_low_texture_stress_vga200(tmp_path):
    _check("rotation_low_texture", tmp_path)


@pytest.mark.slow
def test_mav_motion_vga200(tmp_path):
    _check("mav", tmp_path)


@pytest.mark.slow
def test_primitives_scene_vga200(tmp_path):
    _check("primitives", tmp_path)
