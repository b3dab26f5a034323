"""The port's launchers (``scripts/torch/*.sh``) against the JAX package's
(``scripts/*.sh``): each of the twelve pairs, run by bash with the same
arguments and extra ``--set`` overrides, gives the port's ``parse_args``
the ``Config`` that the JAX script gives JAX's ``parse_args``. The
launched programs are stand-ins on PATH that record their argv; the
training twins start ``torchrun --standalone --nproc_per_node $NPROC`` of
``toist_tpu_torch.main``, the others ``python -m``.
"""
import os
import subprocess

import pytest

from toist_tpu import main as jmain
from toist_tpu_torch.main import parse_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(f for f in os.listdir(os.path.join(REPO, "scripts"))
                 if f.endswith(".sh"))
TRAIN = {"train_dete.sh", "train_dete_dis.sh", "train_dete_noun.sh",
         "train_dete_scratch.sh", "train_seg.sh", "train_seg_dis.sh"}
# Each script's positional checkpoints (one where not listed); then an
# option the user appends (after a --set list or after --output-dir,
# whichever the script ends with).
POSITIONAL = {"train_dete.sh": [], "train_dete_noun.sh": [],
              "train_dete_scratch.sh": [],
              "train_dete_dis.sh": ["student.pth", "teacher.npz"]}
EXTRA = ["--output-dir", "elsewhere"]
_RECORDER = """#!/bin/bash
printf '%s\\0' "$(basename "$0")" "$@" > "$ARGV_OUT"
"""


def _argv(tmp_path, script, nproc="2"):
    """The argv the script hands its program, and the program's name."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    for prog in ("python", "torchrun"):
        (bin_dir / prog).write_text(_RECORDER)
        (bin_dir / prog).chmod(0o755)
    out = tmp_path / "argv"
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
               ARGV_OUT=str(out), NPROC=nproc)
    ckpts = POSITIONAL.get(os.path.basename(script), ["ckpt.pth"])
    subprocess.run(["bash", script, *ckpts, *EXTRA], cwd=REPO, env=env,
                   check=True, timeout=60)
    prog, *argv = out.read_bytes().decode().split("\0")[:-1]
    return prog, argv


def test_every_jax_launcher_has_a_twin():
    assert len(SCRIPTS) == 12
    assert sorted(os.listdir(os.path.join(REPO, "scripts", "torch"))) == \
        SCRIPTS


@pytest.mark.parametrize("name", SCRIPTS)
def test_twin_parses_to_the_jax_config(name, tmp_path):
    jprog, jargv = _argv(tmp_path, os.path.join("scripts", name))
    prog, argv = _argv(tmp_path, os.path.join("scripts", "torch", name))
    assert jprog == "python"
    module = "toist_tpu.visualize" if name == "visualize.sh" else \
        "toist_tpu.main"
    assert jargv[:2] == ["-m", module]
    if name in TRAIN:
        assert prog == "torchrun"
        assert argv[:6] == ["--standalone", "--nproc_per_node", "2", "-m",
                            "toist_tpu_torch.main", "--config"]
        argv = argv[3:]
    else:
        assert prog == "python"
    assert argv[:2] == ["-m", module.replace("toist_tpu.", "toist_tpu_torch.")]
    assert parse_args(argv[2:]).to_dict() == \
        jmain.parse_args(jargv[2:]).to_dict()
    # The positional checkpoints and the user's option reached it.
    cfg = parse_args(argv[2:])
    run = cfg.run
    assert run.output_dir == "elsewhere"
    given = {"train_dete_dis.sh": [run.load, run.load_noun]}.get(
        name, [p for p in (run.load, run.resume) if p])
    assert given == POSITIONAL.get(name, ["ckpt.pth"])
