"""chip_smoke.py rehearsed on the CPU: its phases at toy sizes (the
kernel through the Pallas interpreter), and its refusal to report
anything without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_main_refuses_the_cpu(capsys):
    with pytest.raises(chip_smoke.PhaseError, match="not a GPU"):
        chip_smoke.main([])
    out = capsys.readouterr().out
    assert "card:" in out and '"ok"' not in out


def test_phase_device_refuses_the_cpu():
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.phase_device()


def test_phase_vcycle_matches_the_oracle():
    assert chip_smoke.phase_vcycle(n=64) <= chip_smoke.STEP_TOL


def test_phase_solves_at_toy_sizes():
    out = chip_smoke.phase_solves("cpu", n2=256, n_big=128, n3=16,
                                  n3_cycle=32, n_batch=128, cpu_cycles=None)
    assert {"256^2 tuned", "256^2 fast", "128^2 tuned", "16^3 tuned",
            "32^3 vcycle", "256^2 mixed bf16/f32",
            "batched 4x128^2"} <= set(out)


def test_phase_kernel_interpreted():
    worst = chip_smoke.phase_kernel("cpu", sizes=(64,), interpret=True,
                                    block=(32, 64))
    assert len(worst) == 6          # 3 smoothers x 2 dtypes


def test_phase_four_on_virtual_devices():
    diffs = chip_smoke.phase_four(n2=128, n3=16, mesh_shape=(2, 2))
    assert len(diffs) == 4 and max(diffs.values()) <= chip_smoke.STEP_TOL


def test_check_raises_with_its_message():
    with pytest.raises(chip_smoke.PhaseError, match="boom"):
        chip_smoke.check(False, "boom")


def test_script_alone_fails_without_a_result(tmp_path):
    """Copied out of the checkout, the script cannot import the solver:
    it must exit non-zero and print no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    for line in lines[-1:]:
        with pytest.raises(ValueError):
            json.loads(line)
