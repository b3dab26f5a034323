"""``toist_tpu_torch/utils/pretrained.py`` against
``toist_tpu/utils/pretrained.py``.

The files are synthetic: random state dicts from a seed in torchvision's
ResNet layout (``resnet18-test``: conv1, bn1, layerS.B.*, fc, the BN
``num_batches_tracked``), timm's EfficientNet-B0 layout (conv_stem, bn1,
blocks.S.B.*, and the head conv_head / bn2 / classifier that features_only
drops) and Hugging Face's RobertaModel layout (with its ``position_ids``
buffer and the pooler), written to temporary ``.pth`` files. Both packages
start from the same weights (the port's fresh model, converted to JAX),
apply the same files, and must end with the same weights bit for bit; the
backbone and the text encoder then give the same outputs (f32, 1e-5 of
the max abs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toist_tpu.config import Config as JConfig
from toist_tpu.models.resnet import make_resnet
from toist_tpu.models.text_encoder import RobertaEncoder as JRoberta
from toist_tpu.utils import pretrained as jpre
from toist_tpu.utils.convert import convert_torch_state_dict
from toist_tpu_torch.config import Config
from toist_tpu_torch.models.init import init_like_jax
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.utils import pretrained as ppre
from toist_tpu_torch.utils.convert import jax_params_to_state_dict

MODEL = {"hidden_dim": 64, "nheads": 4, "dim_feedforward": 128,
         "enc_layers": 1, "dec_layers": 1, "num_queries": 8,
         "compute_dtype": "float32", "contrastive_align_loss": False,
         "text_hidden": 64, "text_layers": 2, "text_heads": 4,
         "text_intermediate": 128}
VOCAB = 600


def _rand_like(sd, seed):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if k.endswith("running_var"):
            out[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            out[k] = torch.randn(v.shape, generator=g) * 0.1
    return out


def _files(tmp_path, backbone, seed=0):
    """(backbone file, text file) in torchvision / timm and HF layouts."""
    cfg = _cfg(backbone, contrastive=True)
    with torch.device("meta"):
        model = TOIST(cfg.model, text_vocab_size=VOCAB)
    body = {k[len(ppre.BACKBONE):]: v for k, v in model.state_dict().items()
            if k.startswith(ppre.BACKBONE)}
    body = _rand_like(body, seed)
    for k in [k for k in body if k.endswith("running_var")]:
        body[k.replace("running_var", "num_batches_tracked")] = \
            torch.tensor(7)
    if backbone.startswith("timm_"):
        body.update({"conv_head.weight": torch.randn(1280, 320, 1, 1),
                     "bn2.weight": torch.ones(1280),
                     "classifier.weight": torch.randn(1000, 1280)})
    else:
        body.update({"fc.weight": torch.randn(1000, 2048),
                     "fc.bias": torch.randn(1000)})
    text = {k[len(ppre.TEXT):]: v for k, v in model.state_dict().items()
            if k.startswith(ppre.TEXT)}
    text = _rand_like(text, seed + 1)
    text["embeddings.position_ids"] = torch.arange(514)[None]
    paths = (str(tmp_path / f"{backbone}.pth"), str(tmp_path / "roberta.bin"))
    torch.save(body, paths[0])
    torch.save(text, paths[1])
    return paths


def _cfg(backbone, contrastive=False, **run):
    return Config.from_sources(None, {
        "model": dict(MODEL, backbone=backbone,
                      contrastive_loss=contrastive), "run": run})


def _port(cfg, seed=3):
    model = TOIST(cfg.model, text_vocab_size=VOCAB)
    return init_like_jax(model, torch.Generator().manual_seed(seed)).eval()


def _to_jax(sd, backbone):
    """The port's state dict as JAX (params, frozen) trees."""
    np_sd = {k: v.numpy() for k, v in sd.items()}
    params, frozen = convert_torch_state_dict(
        np_sd, d_model=64, enc_layers=1, dec_layers=1,
        stage_sizes=(1, 1, 1, 1))
    if backbone.startswith("timm_"):
        params["backbone"], frozen["frozen"]["backbone"] = \
            jpre.convert_timm_efficientnet(
                {k[len(ppre.BACKBONE):]: v for k, v in np_sd.items()
                 if k.startswith(ppre.BACKBONE)})
    return params, frozen


@pytest.mark.parametrize("backbone", ["resnet18-test",
                                      "timm_efficientnet_b0"])
def test_apply_pretrained_matches_jax(tmp_path, backbone):
    bfile, tfile = _files(tmp_path, backbone)
    cfg = _cfg(backbone, pretrained_backbone=bfile, pretrained_text=tfile)
    model = _port(cfg)
    params, frozen = _to_jax(model.state_dict(), backbone)
    jcfg = JConfig.from_sources(None, cfg.to_dict())
    jparams, jfrozen = jpre.apply_pretrained(jcfg, params, frozen)
    ppre.apply_pretrained(cfg, model)
    want = jax_params_to_state_dict(jparams, jfrozen)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    body = torch.load(bfile)
    assert torch.equal(got[ppre.BACKBONE + "bn1.running_var"],
                       body["bn1.running_var"])

    rng = np.random.default_rng(0)
    ids = np.full((2, 10), 1, np.int32)
    ids[0, :7] = rng.integers(3, VOCAB, 7)
    ids[1, :4] = rng.integers(3, VOCAB, 4)
    jte = JRoberta(vocab_size=VOCAB, hidden_size=64, num_layers=2,
                   num_heads=4, intermediate_size=128)
    jtext = jax.jit(jte.apply)({"params": jparams["text_encoder"]}, ids,
                               ids == 1)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        text = model.transformer.text_encoder(torch.from_numpy(ids),
                                              torch.from_numpy(ids == 1))
        feats = model.backbone[0](torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(text.numpy(), np.asarray(jtext),
                               atol=1e-5 * np.abs(jtext).max())
    if backbone == "resnet18-test":
        jb = make_resnet(backbone, "frozen_bn", False, jnp.float32)
        jfeats = jax.jit(jb.apply)({"params": jparams["backbone"],
                                    "frozen": jfrozen["frozen"]["backbone"]},
                                   x)
        want = np.asarray(jfeats["layer4"])
        np.testing.assert_allclose(
            feats["layer4"].permute(0, 2, 3, 1).numpy(), want,
            atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", ["backbone_shape", "text_layers",
                                  "group_norm"])
def test_mismatch_raises_value_error(tmp_path, case):
    """A file that does not fit the model raises ValueError in both
    packages: a tensor of another shape, a text file of another depth, or
    frozen-BN weights into a GroupNorm backbone."""
    bfile, tfile = _files(tmp_path, "resnet18-test")
    if case == "backbone_shape":
        sd = torch.load(bfile)
        sd["layer1.0.conv2.weight"] = torch.zeros(64, 64, 1, 1)
        torch.save(sd, bfile)
        run = {"pretrained_backbone": bfile}
    elif case == "text_layers":
        sd = torch.load(tfile)
        for k in [k for k in sd if k.startswith("encoder.layer.1.")]:
            sd[k.replace("layer.1.", "layer.2.")] = sd[k]
        torch.save(sd, tfile)
        run = {"pretrained_text": tfile}
    else:
        run = {"pretrained_backbone": bfile}
    norm = "group_norm" if case == "group_norm" else "frozen_bn"
    cfg = Config.from_sources(None, {
        "model": dict(MODEL, backbone="resnet18-test", backbone_norm=norm),
        "run": run})
    model = _port(cfg)
    with pytest.raises(ValueError, match="pretrained"):
        ppre.apply_pretrained(cfg, model)
    if case != "group_norm":         # JAX's tree of a frozen-BN model
        params, frozen = _to_jax(_port(cfg).state_dict(), "resnet18-test")
        with pytest.raises(ValueError, match="pretrained"):
            jpre.apply_pretrained(JConfig.from_sources(None, cfg.to_dict()),
                                  params, frozen)


def test_without_pretrain_keeps_the_init(tmp_path):
    bfile, tfile = _files(tmp_path, "resnet18-test")
    cfg = Config.from_sources(None, {
        "model": dict(MODEL, backbone="resnet18-test",
                      without_pretrain=True),
        "run": {"pretrained_backbone": bfile, "pretrained_text": tfile}})
    model = _port(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ppre.apply_pretrained(cfg, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("contrastive", [False, True],
                         ids=["pooler_dropped", "pooler_kept"])
def test_pooler_follows_contrastive_loss(tmp_path, contrastive):
    """keep_pooler = model.contrastive_loss: the pooler lands only in a
    model that has one (the CLS contrastive path)."""
    _, tfile = _files(tmp_path, "resnet18-test")
    cfg = _cfg("resnet18-test", contrastive=contrastive,
               pretrained_text=tfile)
    model = _port(cfg)
    ppre.apply_pretrained(cfg, model)
    sd, text = model.state_dict(), torch.load(tfile)
    key = ppre.TEXT + "pooler.dense.weight"
    assert (key in sd) == contrastive
    if contrastive:
        assert torch.equal(sd[key], text["pooler.dense.weight"])
    assert torch.equal(
        sd[ppre.TEXT + "encoder.layer.1.output.dense.weight"],
        text["encoder.layer.1.output.dense.weight"])


def test_npz_files_load(tmp_path):
    bfile, _ = _files(tmp_path, "resnet18-test")
    sd = torch.load(bfile)
    npz = str(tmp_path / "r.npz")
    np.savez(npz, **{k: v.numpy() for k, v in sd.items()})
    got = ppre.load_state_dict(npz)
    assert set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k
