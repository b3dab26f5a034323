"""Port modules (toist_tpu_torch) against the JAX package on the CPU, in f32.

Weights come from one reference-layout state dict
(``synth_reference_state_dict``): the port loads it directly, the JAX side
through ``convert_torch_state_dict``. Inputs are made with numpy from a seed.
Tolerances: 2e-5 joint encoder, 1e-4 decoder, 3e-5 RoBERTa (ROADMAP.md);
the ResNet features (|x| up to ~10 after four stages) are held to 1e-4
relative, the sums' order being the only difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toist_tpu.models.joint_transformer import JointEncoder, QueryDecoder
from toist_tpu.models.position_encoding import (LearnedPositionEmbedding2D,
                                                sine_position_embedding)
from toist_tpu.models.resnet import make_resnet
from toist_tpu.models.text_encoder import RobertaEncoder
from toist_tpu.models.toist import normalize_uint8_images
from toist_tpu.ops import box_ops as jbox
from toist_tpu.utils.convert import (convert_torch_state_dict,
                                     synth_reference_state_dict)
from toist_tpu_torch.models import joint_transformer as pjt
from toist_tpu_torch.models import position_encoding as ppe
from toist_tpu_torch.models import text_encoder as pte
from toist_tpu_torch.models.resnet import Backbone, downsample_mask
from toist_tpu_torch.models.toist import \
    normalize_uint8_images as p_normalize
from toist_tpu_torch.ops import box_ops as pbox

D, NH, FF, L = 64, 4, 128, 2


@pytest.fixture(scope="module")
def weights():
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=L, dec=L, d=D, dim_feedforward=FF,
        text_layers=L, text_hidden=D, text_intermediate=FF, num_queries=20,
        vocab_size=600, with_masks=False, seed=3)
    params, frozen = convert_torch_state_dict(
        sd, d_model=D, enc_layers=L, dec_layers=L, stage_sizes=(1, 1, 1, 1))
    return ({k: torch.from_numpy(v) for k, v in sd.items()}, params,
            frozen["frozen"])


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _boxes(rng, n):
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(1, 30, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("fn", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh",
                                "box_area", "box_iou", "generalized_box_iou",
                                "masks_to_boxes"])
def test_box_ops(fn):
    rng = np.random.default_rng(0)
    if fn == "masks_to_boxes":
        m = rng.random((5, 12, 17)) < 0.1
        m[2] = False                                     # an empty mask
        args = [m]
    elif fn in ("box_iou", "generalized_box_iou"):
        b2 = _boxes(rng, 6)
        b2[0] = 0.0                                      # a padded box
        args = [_boxes(rng, 4), b2]
    else:
        args = [_boxes(rng, 7)]
    want = getattr(jbox, fn)(*(jnp.asarray(a) for a in args))
    got = getattr(pbox, fn)(*(_t(a) for a in args))
    if isinstance(want, tuple):
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5)


def test_sine_position_embedding():
    mask = np.zeros((2, 7, 9), bool)
    mask[1, 5:, :] = True
    mask[1, :, 6:] = True
    want = sine_position_embedding(jnp.asarray(mask), 32)
    got = ppe.sine_position_embedding(_t(mask), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_learned_position_embedding():
    rng = np.random.default_rng(1)
    row = rng.uniform(size=(50, 16)).astype(np.float32)
    col = rng.uniform(size=(50, 16)).astype(np.float32)
    mod = LearnedPositionEmbedding2D(16)
    want = mod.apply({"params": {"row_embed": row, "col_embed": col}},
                     2, 5, 7)
    port = ppe.LearnedPositionEmbedding2D(16)
    port.load_state_dict({"row_embed.weight": _t(row),
                          "col_embed.weight": _t(col)})
    got = port(torch.zeros(2, 5, 7, dtype=torch.bool), torch.float32)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_frozen_bn_resnet_padded_canvas(weights):
    sd, params, frozen = weights
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 96, 128, 3)).astype(np.float32)
    mask = np.zeros((2, 96, 128), bool)
    mask[1, 64:, :] = True
    mask[1, :, 96:] = True
    x[mask] = 0.0
    jm = make_resnet("resnet18-test", "frozen_bn", False, jnp.float32)
    want = jax.jit(lambda a, m: jm.apply(
        {"params": params["backbone"], "frozen": frozen["backbone"]}, a,
        pad_mask=m))(x, mask)
    port = Backbone("resnet18-test")
    port.load_state_dict(_sub(sd, "backbone.0."))
    with torch.inference_mode():
        got = port(_t(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last), _t(mask))
    for name in ("layer1", "layer2", "layer3", "layer4"):
        g = got[name].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[name])
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    # Features in the padded region are exactly zero.
    fm = downsample_mask(_t(mask), 3, 4).numpy()
    assert (got["layer4"].permute(0, 2, 3, 1).numpy()[fm] == 0).all()


def _gn_state_dict(jparams):
    """The JAX GroupNorm ResNet's params under the port's (the reference's)
    names: conv kernels [kh, kw, in, out] -> [out, in, kh, kw]; each
    Bottleneck's GroupNorm_0..3 -> bn1, bn2, bn3, downsample.1 and the
    stem's GroupNorm_0 -> bn1 (scale -> weight, as convert.py:51 _gn reads
    them)."""
    def conv(p):
        return _t(np.array(p["kernel"]).transpose(3, 2, 0, 1))

    def gn(out, key, p):
        out[f"{key}.weight"] = _t(np.array(p["scale"]))
        out[f"{key}.bias"] = _t(np.array(p["bias"]))

    sd = {"body.conv1.weight": conv(jparams["conv1"])}
    gn(sd, "body.bn1", jparams["GroupNorm_0"])
    for name, p in jparams.items():
        if not name.startswith("layer"):
            continue
        s, b = name[len("layer"):].split("_")
        t = f"body.layer{s}.{b}"
        for i in (1, 2, 3):
            sd[f"{t}.conv{i}.weight"] = conv(p[f"conv{i}"])
            gn(sd, f"{t}.bn{i}", p[f"GroupNorm_{i - 1}"])
        if "downsample_conv" in p:
            sd[f"{t}.downsample.0.weight"] = conv(p["downsample_conv"])
            gn(sd, f"{t}.downsample.1", p["GroupNorm_3"])
    return sd


def test_group_norm_resnet_padded_canvas():
    """The GroupNorm backbone (flax nn.GroupNorm(32), eps 1e-6) on a padded
    canvas, beside test_frozen_bn_resnet_padded_canvas: the same features
    from the same weights (random scales and biases), padded region 0."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 96, 128, 3)).astype(np.float32)
    mask = np.zeros((2, 96, 128), bool)
    mask[1, 64:, :] = True
    mask[1, :, 96:] = True
    x[mask] = 0.0
    jm = make_resnet("resnet18-test", "group_norm", False, jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x[:1], None)["params"]

    def perturb(path, v):          # GroupNorm scales and biases off 1 and 0
        v = np.array(v)
        if path[-1].key == "scale":
            v *= rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif path[-1].key == "bias":
            v += rng.normal(0, 0.1, v.shape).astype(np.float32)
        return v

    params = jax.tree_util.tree_map_with_path(perturb, params)
    want = jax.jit(lambda a, m: jm.apply({"params": params}, a,
                                         pad_mask=m))(x, mask)
    port = Backbone("resnet18-test", norm="group_norm")
    assert sum(isinstance(m, torch.nn.GroupNorm) for m in port.modules()) \
        == 1 + 4 * 4
    port.load_state_dict(_gn_state_dict(params))
    assert all(m.eps == 1e-6 and m.num_groups == 32 for m in port.modules()
               if isinstance(m, torch.nn.GroupNorm))
    with torch.inference_mode():
        got = port(_t(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last), _t(mask))
    for name in ("layer1", "layer2", "layer3", "layer4"):
        g = got[name].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[name])
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    fm = downsample_mask(_t(mask), 3, 4).numpy()
    assert (got["layer4"].permute(0, 2, 3, 1).numpy()[fm] == 0).all()


def test_roberta_dropout_rates(monkeypatch):
    """Training-mode RoBERTa: the embeddings, attention-output and
    FFN-output sites keep a share within 3 sigma of 0.9 and scale kept
    values by exactly 1/0.9 (flax nn.Dropout); the attention probabilities
    keep 230/256 (_dropout_u8). The sites are observed by wrapping the
    module's dropout functions; ``dropout_exact`` alone is held on 10^6
    elements, where 230/256 would lie 5 sigma off."""
    from toist_tpu_torch.models.layers import dropout_exact

    x = torch.full((1000, 1000), 3.0)
    a = dropout_exact(x, 0.1, torch.Generator().manual_seed(1))
    assert torch.equal(a, dropout_exact(x, 0.1,
                                        torch.Generator().manual_seed(1)))
    assert set(a.unique().tolist()) == {0.0, float(x[0, 0] / 0.9)}
    sd = (0.9 * 0.1 / x.numel()) ** 0.5
    assert abs((a != 0).float().mean().item() - 0.9) < 3 * sd
    assert dropout_exact(x, 0.0, None) is x

    sites, keeps = [], []
    real_keep = pte.attention_keep

    def exact(t, rate, g):
        out = dropout_exact(t, rate, g)
        sites.append((t.detach(), out.detach(), rate))
        return out

    def keep(q, k, h, rate, g):
        keeps.append(real_keep(q, k, h, rate, g))
        return keeps[-1]

    monkeypatch.setattr(pte, "dropout_exact", exact)
    monkeypatch.setattr(pte, "attention_keep", keep)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        3, 600, (8, 128)))
    enc = pte.RobertaEncoder(vocab_size=600, hidden_size=D, num_layers=L,
                             num_heads=NH, intermediate_size=FF,
                             dropout=0.1).train()
    with torch.no_grad():
        enc(ids, generator=torch.Generator().manual_seed(3))
    assert len(sites) == 1 + 2 * L and len(keeps) == L
    kept = n = 0
    for t, out, rate in sites:
        assert rate == 0.1
        on = out != 0
        assert torch.equal(out[on], t[on] / 0.9)        # the scale, exactly
        kept, n = kept + on.sum().item(), n + out.numel()
    sd = (0.9 * 0.1 / n) ** 0.5
    assert abs(kept / n - 0.9) < 3 * sd
    share = torch.cat([m.flatten() for m in keeps]).float().mean().item()
    p = 230 / 256
    assert abs(share - p) < 3 * (p * (1 - p) / sum(m.numel()
                                                   for m in keeps)) ** 0.5


def test_roberta(weights):
    sd, params, _ = weights
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 600, (2, 12)).astype(np.int32)
    ids[1, 7:] = 1                                      # padding tokens
    tmask = ids == 1
    jm = RobertaEncoder(vocab_size=600, hidden_size=D, num_layers=L,
                        num_heads=NH, intermediate_size=FF, dropout=0.0)
    want = jax.jit(lambda i, m: jm.apply(
        {"params": params["text_encoder"]}, i, key_padding_mask=m))(ids,
                                                                     tmask)
    port = pte.RobertaEncoder(vocab_size=600, hidden_size=D, num_layers=L,
                              num_heads=NH, intermediate_size=FF,
                              dropout=0.0).eval()
    port.load_state_dict(_sub(sd, "transformer.text_encoder."))
    with torch.inference_mode():
        got = port(_t(ids), _t(tmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def _joint_inputs(seed, s):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(2, s, D)).astype(np.float32)
    pos = rng.normal(size=(2, s, D)).astype(np.float32)
    mask = rng.random((2, s)) < 0.2
    return src, pos, mask


@pytest.mark.parametrize("s", [40, 300])
def test_joint_encoder(weights, s):
    sd, params, _ = weights
    src, pos, mask = _joint_inputs(5, s)
    jm = JointEncoder(D, NH, L, FF, 0.0, jnp.float32, fused="off")
    want = jax.jit(lambda a, p, m: jm.apply(
        {"params": params["encoder"]}, a, p, m))(src, pos, mask)
    port = pjt.JointEncoder(D, NH, L, FF, 0.0).eval()
    port.load_state_dict(_sub(sd, "transformer.encoder."))
    with torch.inference_mode():
        got = port(_t(src), _t(pos), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_query_decoder(weights):
    sd, params, _ = weights
    mem, pos, mask = _joint_inputs(6, 300)
    rng = np.random.default_rng(7)
    qpos = rng.normal(size=(2, 20, D)).astype(np.float32)
    tgt = np.zeros_like(qpos)
    jm = QueryDecoder(D, NH, L, FF, 0.0, jnp.float32, fused="off")
    want = jax.jit(lambda *a: jm.apply({"params": params["decoder"]}, *a))(
        tgt, mem, qpos, pos, mask)
    port = pjt.QueryDecoder(D, NH, L, FF, 0.0).eval()
    port.load_state_dict(_sub(sd, "transformer.decoder."))
    with torch.inference_mode():
        got = port(_t(tgt), _t(mem), _t(qpos), _t(pos), _t(mask))
    assert got.shape == (L, 2, 20, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_normalize_uint8_images():
    rng = np.random.default_rng(8)
    u8 = rng.integers(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    mask = np.zeros((2, 16, 24), bool)
    mask[0, :, 20:] = True
    want = normalize_uint8_images(jnp.asarray(u8), jnp.asarray(mask))
    got = p_normalize(_t(u8), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (got.numpy()[mask] == 0).all()
