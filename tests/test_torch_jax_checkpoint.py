"""A checkpoint the JAX package trained, in the port: ``toist_tpu.train.
checkpoint.save`` writes a tiny TOIST's TrainState (params, EMA, frozen
FrozenBN statistics, the cluster bank, the epoch) through orbax,
``scripts/jax_checkpoint_to_npz.py`` converts it, and the port's
``load_params`` (what ``--load``, ``run.load_noun`` and
``Predictor.from_checkpoint`` call) reads the ``.npz`` with numpy.

The port's forward of the loaded weights holds JAX's forward of the same
state to the full-model 2e-3 of each output's max abs, with the EMA
preferred as ``--load`` prefers it; ``main --eval --load`` of the file with
``loss.cluster`` evaluates with the run's own bank.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_distill import _bank
from tests.test_torch_train import PTINY, TINY, _TINY_SD
from toist_tpu.models.toist import build_model
from toist_tpu.train import checkpoint as jckpt
from toist_tpu.train.state import TrainState
from toist_tpu.utils.convert import (convert_torch_state_dict,
                                     synth_reference_state_dict)
from toist_tpu_torch import main as pmain
from toist_tpu_torch.config import Config
from toist_tpu_torch.data.captions import build_tokenizer
from toist_tpu_torch.data.fixtures import generate_fixture
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.train import checkpoint as pckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-3


def _over(root):
    model = {k: v for k, v in dataclasses.asdict(PTINY).items()
             if k in ("backbone", "hidden_dim", "nheads", "dim_feedforward",
                      "enc_layers", "dec_layers", "num_queries",
                      "compute_dtype", "contrastive_hdim", "text_hidden",
                      "text_layers", "text_heads", "text_intermediate",
                      "dropout", "resizer_dropout")}
    return {"model": model,
            "data": {"coco_path": root,
                     "refexp_ann_path": f"{root}/annotations",
                     "tasks": [1, 2], "image_buckets": [[128, 128]],
                     "max_text_len": 48, "max_boxes": 8, "train_scales": [96],
                     "max_size": 128, "val_size": 96},
            "loss": {"cluster": True, "cluster_memory_size": 16,
                     "cluster_num": 2, "kmeans_max_iters": 8},
            "optim": {"valid_batch_size": 2}}


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(fixture root, JAX params, EMA, frozen, bank, the .npz path): a JAX
    TrainState at the fixture tokenizer's vocabulary, saved by the JAX
    package and converted by the script."""
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    root = generate_fixture(str(tmp / "data"), num_tasks=2, imgs_per_split=2,
                            img_size=(96, 128), seed=3)
    vocab = build_tokenizer(Config.from_sources(None, _over(root))).vocab_size
    sd = synth_reference_state_dict(seed=5, **dict(_TINY_SD,
                                                   vocab_size=vocab))
    params, frozen = convert_torch_state_dict(
        sd, d_model=64, enc_layers=2, dec_layers=2, stage_sizes=(1, 1, 1, 1))
    ema = jax.tree_util.tree_map(
        lambda x: x + 0.01 * np.sign(np.asarray(x)), params)
    tx = optax.adamw(1e-4)
    state = TrainState(params=params, opt_state=tx.init(params),
                       ema_params=ema, step=jnp.int32(7),
                       cluster_bank=_bank())
    ckpt_dir = str(tmp / "checkpoint")
    jckpt.save(ckpt_dir, state, frozen, epoch=3)
    npz = str(tmp / "checkpoint.npz")
    tool = os.path.join(REPO, "scripts", "jax_checkpoint_to_npz.py")
    p = subprocess.run([sys.executable, tool, ckpt_dir, npz], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-3000:]
    return root, vocab, params, ema, frozen, npz


def _forwards(jmodel, variables, port, seed=9, b=2, h=128, w=160):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    image_mask = np.zeros((b, h, w), bool)
    image_mask[1, 96:] = True
    text_ids = np.full((b, 12), 1, np.int32)
    text_ids[0, :7] = rng.integers(3, 300, 7)
    text_ids[1, :4] = rng.integers(3, 300, 4)
    args = (images, image_mask, text_ids, text_ids == 1)
    cache = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=jmodel.encode))(
        variables, *args)
    jout = jax.jit(lambda v, c: jmodel.apply(v, c, method=jmodel.decode))(
        variables, cache)
    with torch.inference_mode():
        out = port.decode(port.encode(*(torch.from_numpy(a) for a in args)))
    return jout, out


@pytest.mark.parametrize("prefer_ema", [True, False])
def test_port_forward_of_a_jax_checkpoint(converted, prefer_ema):
    root, vocab, params, ema, frozen, npz = converted
    sd = pckpt.load_params(npz, prefer_ema=prefer_ema)
    port = TOIST.from_state_dict(sd, PTINY, device="cpu")
    jmodel = build_model(TINY, text_vocab_size=vocab, tiny_text=True,
                         backbone_norm="frozen_bn")
    want_params = ema if prefer_ema else params
    jout, out = _forwards(jmodel, {"params": want_params, **frozen}, port)
    for k in ("pred_logits", "pred_boxes"):
        w = np.asarray(jout[k])
        err = np.abs(out[k].numpy() - w).max()
        assert err <= TOL * np.abs(w).max(), (k, err)
    # The other weights are 0.01 away: the file held both.
    other = pckpt.load_params(npz, prefer_ema=not prefer_ema)
    key = "class_embed.weight"
    assert not torch.equal(other[key], sd[key])


def test_main_eval_loads_the_npz_and_its_bank(converted, tmp_path,
                                              monkeypatch):
    """``main --eval --load ckpt.npz`` with ``loss.cluster``: the model
    takes the EMA weights and the cluster eval reads the JAX run's bank."""
    root, *_, npz = converted
    banks, make = [], pmain.make_eval_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def eval_step(batch, bank=None):
            banks.append(bank)
            return step(batch, bank)
        return eval_step

    monkeypatch.setattr(pmain, "make_eval_step", recording)
    over = _over(root)
    over["run"] = {"load": npz, "eval_only": True,
                   "output_dir": str(tmp_path / "out")}
    ap = pmain.main(Config.from_sources(None, over), device="cpu")
    assert np.isfinite(ap) and banks
    want = _bank()
    for f in ("feature_bank", "cluster_centers", "update_count", "full"):
        np.testing.assert_array_equal(getattr(banks[0], f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert pckpt.load_jax_cluster_bank(npz, "cpu") is not None
    assert pckpt.load_jax_cluster_bank(str(tmp_path / "x.pth"), "cpu") is None
