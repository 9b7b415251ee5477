"""End-to-end CLI test of the port's trainer: train → checkpoint → restart
resumes (twin of ``tests/test_cli_resume.py``), on four CPU ranks."""

import os
import subprocess
import sys

from conftest import SRC


def _run_train(tmp, steps):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "mamba2-130m", "--smoke", "--steps", str(steps),
         "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp),
         "--ckpt-every", "2", "--straggle-p", "0.3", "--mesh", "4x1",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=600)


def test_train_checkpoint_resume(tmp_path):
    p1 = _run_train(tmp_path, 4)
    assert p1.returncode == 0, p1.stderr[-2000:]
    assert "checkpointed step 4" in p1.stdout
    ckpts = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert ckpts, p1.stdout

    p2 = _run_train(tmp_path, 3)
    assert p2.returncode == 0, p2.stderr[-2000:]
    assert "resumed from step 4" in p2.stdout
    assert "step    7" in p2.stdout or "checkpointed step 7" in p2.stdout


def test_train_cli_needs_a_card_without_device(tmp_path):
    import torch
    if torch.cuda.is_available():
        return
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-130m", "--smoke", "--steps", "1"],
        env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "no CUDA device" in p.stderr
