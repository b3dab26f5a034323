"""Distillation learning-effect gate of the port, on the CPU.

Runs ``python -m toist_tpu_torch.scripts.fixture_distill_ablation`` (the
verb-noun teacher, the plain student and the distilled student through
``toist_tpu_torch.main``, the config of scripts/fixture_distill_ablation.py)
in a subprocess and holds it to the JAX gate's floor
(tests/test_distill_ablation_gate.py): the distilled student beats the
plain one by more than 0.015 AP@0.5, so a sign or detach fault in the
softkd / nsthl2 / cluster gradients cannot pass silently.

Six epochs, the script's default: at two, the fixture's AP moves by more
than the margin with the CPU thread count alone (the margin read -0.048
with the default threads and +0.199 with one). The subprocess runs on one
thread, so its result is the same on every run.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_distilled_student_beats_plain_student(tmp_path):
    out = tmp_path / "ablation.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "toist_tpu_torch.scripts.fixture_distill_ablation",
         "--epochs", "6", "--device", "cpu", "--workdir",
         str(tmp_path / "work"), "--out", str(out)],
        capture_output=True, text=True, timeout=900, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(out.read_text())
    margin = res["distill_student_ap50"] - res["plain_student_ap50"]
    assert margin > 0.015, (
        "distillation learning-effect regression: distilled student "
        f"{res['distill_student_ap50']:.4f} vs plain "
        f"{res['plain_student_ap50']:.4f} AP@0.5 (margin {margin:+.4f}, "
        "expected > +0.015)")
