"""The port's EfficientNet backbones (``toist_tpu_torch/models/
efficientnet.py``) against ``toist_tpu/models/efficientnet.py``.

Shared weights: the port's timm-named backbone state dict goes to JAX
through the JAX package's own ``convert_timm_efficientnet`` (the port keeps
timm's names), and comes back through the port's
``jax_params_to_state_dict`` bit for bit. The B0 trunk runs at 64x96 on
both sides (features within 1e-5 of each level's max abs, f32); B3 and B5
are held by parameter names and shapes only, from ``jax.eval_shape`` of
JAX's init (nothing compiles), so no deep trunk runs here. A tiny TOIST on
``timm_efficientnet_b0`` matches JAX within 2e-3, with and without the
mask head (whose adapters take the trunk's 112 / 40 / 24 channels), and
``main`` on B0 with remat and the plain attention trains and evaluates.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toist_tpu.config import ModelConfig
from toist_tpu.models.efficientnet import make_efficientnet as jmake
from toist_tpu.models.toist import build_model
from toist_tpu.utils.convert import convert_torch_state_dict
from toist_tpu.utils.pretrained import convert_timm_efficientnet
from tests.test_torch_main import _overrides
from toist_tpu_torch import config as pconfig
from toist_tpu_torch.config import Config
from toist_tpu_torch.data.fixtures import generate_fixture
from toist_tpu_torch.main import main
from toist_tpu_torch.models.efficientnet import (efficientnet_num_channels,
                                                 make_efficientnet,
                                                 parse_timm_efficientnet)
from toist_tpu_torch.models.init import init_like_jax
from toist_tpu_torch.models.resnet import Backbone
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.utils import convert
from toist_tpu_torch.utils.convert import jax_params_to_state_dict

BODY = "backbone.0.body."


def _randomize(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """flax's initialisers, then random frozen-BN statistics (so that the
    norms are not the identity)."""
    g = torch.Generator().manual_seed(seed)
    if isinstance(model, TOIST):
        init_like_jax(model, g)
    with torch.no_grad():
        for n, t in model.named_parameters():
            if "se.conv" in n and n.endswith("bias"):
                t.uniform_(-0.5, 0.5, generator=g)
            elif n.endswith("weight") and t.dim() == 4 and \
                    not isinstance(model, TOIST):
                t.normal_(0.0, (1.0 / t[0].numel()) ** 0.5, generator=g)
        for n, b in model.named_buffers():
            if n.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=g)
            elif n.endswith("running_mean") or n.endswith("bias"):
                b.normal_(0.0, 0.1, generator=g)
            elif n.endswith("weight"):
                b.uniform_(0.8, 1.2, generator=g)
    return model


def _timm(sd, prefix=BODY):
    return {k[len(prefix):]: v.numpy() for k, v in sd.items()
            if k.startswith(prefix)}


def _jax_backbone(params, frozen):
    """JAX's EfficientNet trees -> the port's backbone state dict, through
    the backbone part of ``jax_params_to_state_dict``."""
    out = convert._Out()
    convert._backbone(out, {"backbone": params}, {"backbone": frozen})
    return out.sd


def _inputs(seed, b=2, h=64, w=96):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    mask = np.zeros((b, h, w), bool)
    mask[-1, 5 * h // 8:, :] = True
    mask[-1, :, 3 * w // 4:] = True
    return x, mask


@pytest.fixture(scope="module")
def b0_pair():
    port = _randomize(make_efficientnet("b0"), 3)
    jp, jf = convert_timm_efficientnet(_timm(
        {BODY + k: v for k, v in port.state_dict().items()}))
    return port, {"params": jp, "frozen": jf}


def test_b0_trunk_matches_jax(b0_pair):
    port, variables = b0_pair
    x, mask = _inputs(0)
    jfeats = jax.jit(lambda v, a, m: jmake("b0", "frozen_bn", jnp.float32)
                     .apply(v, a, m))(variables, x, mask)
    with torch.no_grad():
        feats = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(mask))
    assert set(feats) == set(jfeats) == {"layer1", "layer2", "layer3",
                                         "layer4"}
    for k, want in jfeats.items():
        want = np.asarray(want)
        got = feats[k].permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_converter_round_trip_bit_exact(b0_pair):
    """timm-named port weights -> JAX (the JAX package's timm converter) ->
    the port's jax_params_to_state_dict: the same tensors back."""
    port, variables = b0_pair
    out = _jax_backbone(variables["params"], variables["frozen"])
    want = {BODY + k: v for k, v in port.state_dict().items()}
    assert set(out) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(out[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("variant", ["b3", "b5"])
def test_parameter_names_and_shapes_match_jax(variant):
    """Every backbone tensor of B3 / B5 under its timm name with JAX's
    shape (from jax.eval_shape of its init, converted by name)."""
    jm = jmake(variant, "frozen_bn", jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    sd = _jax_backbone(zeros["params"], zeros["frozen"])
    with torch.device("meta"):
        port = make_efficientnet(variant)
    mine = {BODY + k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert mine == {k: tuple(v.shape) for k, v in sd.items()}
    assert port.channels["layer4"] == efficientnet_num_channels(variant)


def test_canvas_invariance_under_padding(b0_pair):
    """A sample on a larger canvas (padding past 64x96) gives the same
    features on its real region."""
    port, _ = b0_pair
    x, _ = _inputs(1, b=1)
    big = np.zeros((1, 96, 128, 3), np.float32)
    big[:, :64, :96] = x
    mask = np.ones((1, 96, 128), bool)
    mask[:, :64, :96] = False
    with torch.no_grad():
        small = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.zeros((1, 64, 96), dtype=torch.bool))
        padded = port(torch.from_numpy(big).permute(0, 3, 1, 2),
                      torch.from_numpy(mask))
    for k, f in small.items():
        h, w = f.shape[2:]
        np.testing.assert_allclose(padded[k][:, :, :h, :w].numpy(),
                                   f.numpy(), atol=1e-5, err_msg=k)
        assert not padded[k][:, :, h:].any() and not padded[k][:, :, :,
                                                              w:].any()


def test_dispatch_and_channels():
    assert parse_timm_efficientnet("timm_tf_efficientnet_b3_ns") == "b3"
    assert parse_timm_efficientnet("timm_efficientnet_b0") == "b0"
    assert parse_timm_efficientnet("timm_resnest101e") is None
    with torch.device("meta"):
        b3 = Backbone("timm_tf_efficientnet_b3_ns")
        with pytest.raises(ValueError, match="timm backbone"):
            Backbone("timm_resnest101e")
    assert b3.body.channels == {"layer1": 32, "layer2": 48, "layer3": 136,
                                "layer4": 384}
    assert [efficientnet_num_channels(v) for v in ("b0", "b3", "b5")] == \
        [320, 384, 512]
    names = list(b3.state_dict())
    assert "body.blocks.0.0.conv_pw.weight" in names       # DS projection
    assert "body.blocks.1.0.conv_pwl.weight" in names      # IR projection
    assert "body.blocks.1.0.se.conv_reduce.bias" in names


TINY = ModelConfig(backbone="timm_efficientnet_b0", hidden_dim=64, nheads=4,
                   dim_feedforward=128, enc_layers=1, dec_layers=1,
                   num_queries=8, compute_dtype="float32",
                   contrastive_align_loss=True, contrastive_hdim=16,
                   text_hidden=64, text_layers=1, text_heads=4,
                   text_intermediate=128, dropout=0.0, resizer_dropout=0.0,
                   fused_attention="off")
VOCAB = 600


@pytest.mark.parametrize("masks", [False, True], ids=["no_masks", "masks"])
def test_tiny_toist_on_b0_matches_jax(masks):
    jcfg = dataclasses.replace(TINY, mask_model="smallconv" if masks
                               else "none", masks=masks)
    if masks:
        jcfg = dataclasses.replace(jcfg, hidden_dim=128, nheads=8)
    pcfg = pconfig.ModelConfig(**dataclasses.asdict(jcfg))
    port = TOIST(pcfg, text_vocab_size=VOCAB)
    _randomize(port, 11)
    sd = {k: v.detach().clone() for k, v in port.state_dict().items()}
    params, frozen = convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, d_model=jcfg.hidden_dim,
        enc_layers=1, dec_layers=1, with_masks=masks)
    params["backbone"], frozen["frozen"]["backbone"] = \
        convert_timm_efficientnet(_timm(sd))
    back = jax_params_to_state_dict(params, frozen)
    assert set(back) == set(sd)
    port = port.eval()
    jmodel = build_model(jcfg, text_vocab_size=VOCAB,
                         backbone_norm="frozen_bn")
    rng = np.random.default_rng(4)
    x, mask = _inputs(5, h=96, w=128)
    images = np.clip(x * 60 + 120, 0, 255).astype(np.uint8)
    text_ids = np.full((2, 12), 1, np.int32)
    text_ids[0, :7] = rng.integers(3, VOCAB, 7)
    text_ids[1, :4] = rng.integers(3, VOCAB, 4)
    args = [images, mask, text_ids, text_ids == 1]
    variables = {"params": params, **frozen}

    def jfwd(v, *a):
        cache = jmodel.apply(v, *a, method=jmodel.encode)
        out = jmodel.apply(v, cache, method=jmodel.decode)
        if masks:
            out["pred_masks"] = jmodel.apply(
                v, cache, out["hs"][-1], method=jmodel.compute_masks)
        return out
    jout = jax.jit(jfwd)(variables, *args)
    with torch.inference_mode():
        out, cache = port(*(torch.from_numpy(a) for a in args))
        if masks:
            out["pred_masks"] = port.compute_masks(cache, out["hs"][-1])
    keys = ["pred_logits", "pred_boxes", "hs"] + (["pred_masks"] if masks
                                                  else [])
    for k in keys:
        want = np.asarray(jout[k])
        np.testing.assert_allclose(out[k].numpy(), want, atol=2e-3 * max(
            1.0, np.abs(want).max()), err_msg=k)


def test_main_runs_efficientnet_with_remat_and_plain_attention(tmp_path):
    """``main`` on the CPU with model.backbone=timm_efficientnet_b0,
    model.remat and model.fused_attention=off at the tiny size: one epoch,
    its checkpoint (timm's names under backbone.0.body, input_proj over
    B0's 320 channels) and a finite eval."""
    root = generate_fixture(str(tmp_path / "data"), num_tasks=2,
                            imgs_per_split=2, img_size=(96, 128), seed=1)
    out = str(tmp_path / "out")
    over = _overrides(root, out, "frozen_bn")
    over["optim"]["epochs"] = 1
    over["model"].update(backbone="timm_efficientnet_b0", remat=True,
                         fused_attention="off")
    assert np.isfinite(main(Config.from_sources(None, over), device="cpu"))
    payload = torch.load(f"{out}/checkpoint", weights_only=False)
    assert payload["model"]["input_proj.weight"].shape[1] == 320
    assert "backbone.0.body.blocks.0.0.conv_dw.weight" in payload["model"]
