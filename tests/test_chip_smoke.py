"""chip_smoke.py's phases at tiny sizes on the CPU: the same checks the
card run makes, so a broken phase shows here before it costs a card run.
The four-device phase runs on four of the eight virtual devices."""

import importlib.util
import os

import jax
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CARD = "test card, 0 W"


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_a_non_gpu_platform(argv, capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr()
    assert "no GPU found" in out.err
    assert not any(l.startswith("{") for l in out.out.splitlines())


def test_phase_device(capsys):
    chip_smoke.phase_device(CARD)
    out = capsys.readouterr().out
    assert "device_kind" in out and CARD in out


def test_phase_cli(tmp_path, capsys):
    chip_smoke.phase_cli(CARD, str(tmp_path), platform="cpu",
                         shape=(16, 16, 12), steps=4, jump_steps=2)
    out = capsys.readouterr().out
    assert "[cli]" in out and "operator=coded" in out
    assert sorted(os.listdir(tmp_path / "cli_out")) == [
        "field_1.vtk", "src_1.vtk"]


def test_phase_cli_fails_on_wrong_platform(tmp_path):
    with pytest.raises(AssertionError, match="backend line"):
        chip_smoke.phase_cli(CARD, str(tmp_path), platform="gpu",
                             shape=(16, 16, 12), steps=2, jump_steps=1)


def test_phase_mechanisms(tmp_path, capsys):
    chip_smoke.phase_mechanisms(CARD, str(tmp_path), moving_shape=(16, 16, 12),
                                lim_shape=(24, 11, 10), steps=3, jump_steps=1)
    out = capsys.readouterr().out
    assert "moving" in out and "lim" in out and "coil moved" in out


def test_phase_scale(capsys):
    chip_smoke.phase_scale(CARD, shape=(16, 16, 12), steps=2)
    out = capsys.readouterr().out
    assert "ms/step" in out and "peak_bytes_in_use" in out


def test_phase_operator(capsys):
    chip_smoke.phase_operator(CARD, shapes=((16, 14, 12), (13, 17, 12)))
    lines = capsys.readouterr().out.splitlines()
    assert sum("coded f32 vs field f64" in l for l in lines) == 2
    assert sum("field f32 vs field f64" in l for l in lines) == 2


def test_phase_precision(capsys):
    chip_smoke.phase_precision(CARD, shape=(16, 14, 12), steps=3)
    assert "carry" in capsys.readouterr().out


def test_phase_four(capsys):
    chip_smoke.phase_four(CARD, shape=(16, 16, 12), steps=2, n=4)
    out = capsys.readouterr().out
    assert "4 devices shard_map-field" in out
