"""The forward's split for graph replay, on the CPU.

``TOIST.encode`` runs ``encode_unimodal`` (everything before the joint
encoder) and then the joint encoder; the Predictor replays the first part as
a CUDA graph on the card (``predict.UnimodalGraphs``; the replay itself is
tested in ``tests/test_torch_cuda.py``). Here: the split ``encode`` gives
the unsplit one's cache bit for bit, in eval mode and in training mode with
dropout drawn from a generator, with and without the CLS token of
``contrastive_loss``; the device-kept normalization constants give the host
constants' result bit for bit; and a CPU Predictor runs the method eagerly,
capturing nothing.
"""
import dataclasses

import numpy as np
import pytest
import torch

from toist_tpu_torch import config as pconfig
from toist_tpu_torch.data.transforms import _NORM_SCALE, _NORM_SHIFT
from toist_tpu_torch.models import toist as toist_mod
from toist_tpu_torch.models.resnet import downsample_mask
from toist_tpu_torch.models.toist import TOIST, normalize_uint8_images

TINY = pconfig.ModelConfig(
    backbone="resnet18-test", hidden_dim=64, nheads=4, dim_feedforward=128,
    enc_layers=2, dec_layers=2, num_queries=20, compute_dtype="float32",
    contrastive_align_loss=True, contrastive_hdim=16, text_hidden=64,
    text_layers=2, text_heads=4, text_intermediate=128, dropout=0.1,
    resizer_dropout=0.1)
VOCAB = 600


def _host_normalize(images, image_mask):
    """The normalization with its constants uploaded on every call."""
    scale = torch.as_tensor(_NORM_SCALE, device=images.device)
    shift = torch.as_tensor(_NORM_SHIFT, device=images.device)
    keep = (~image_mask)[..., None].float()
    return (images.float() * scale - shift) * keep


def _unsplit_encode(model, images, image_mask, text_ids, text_mask,
                    generator=None):
    """``TOIST.encode`` as one method, before the split."""
    cfg, dt = model.cfg, model.compute_dtype
    d = cfg.hidden_dim
    if images.dtype == torch.uint8:
        images = _host_normalize(images, image_mask)
    x = images.to(dt).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    feats = model.backbone[0](x, pad_mask=image_mask)
    src = feats["layer4"]
    B, _, fh, fw = src.shape
    fmask = downsample_mask(image_mask, fh, fw)
    pos = model.backbone[1](fmask, dt)
    src = model.input_proj(src)
    img_tokens = src.permute(0, 2, 3, 1).reshape(B, fh * fw, d)
    pos_tokens = pos.reshape(B, fh * fw, d)
    img_token_mask = fmask.reshape(B, fh * fw)
    tr = model.transformer
    text_pooled = None
    if cfg.contrastive_loss:
        cls_tok = tr.CLS.weight.to(dt)[None].expand(B, 1, d)
        img_tokens = torch.cat([cls_tok, img_tokens], dim=1)
        pos_tokens = torch.cat([pos_tokens.new_zeros(B, 1, d), pos_tokens],
                               dim=1)
        img_token_mask = torch.cat(
            [img_token_mask.new_zeros(B, 1), img_token_mask], dim=1)
        text_last, text_pooled = tr.text_encoder(text_ids, text_mask,
                                                 generator)
    else:
        text_last = tr.text_encoder(text_ids, text_mask, generator)
    text_resized = tr.resizer(text_last, generator)
    joint = torch.cat([img_tokens, text_resized.to(dt)], dim=1)
    joint_mask = torch.cat([img_token_mask, text_mask], dim=1)
    joint_pos = torch.cat([pos_tokens, torch.zeros_like(text_resized,
                                                        dtype=dt)], dim=1)
    img_memory = tr.encoder(joint, joint_pos, joint_mask, generator)
    T = text_ids.shape[1]
    cache = {
        "text_memory_resized": text_resized,
        "text_memory": img_memory[:, -T:], "img_memory": img_memory,
        "mask": joint_mask, "text_attention_mask": text_mask,
        "pos_embed": joint_pos, "feature_hw": (fh, fw),
        "features_c2": feats["layer1"], "features_c3": feats["layer2"],
        "features_c4": feats["layer3"], "src_proj": src,
        "feature_mask": fmask,
    }
    if cfg.contrastive_loss:
        cache["text_pooled_op"] = text_pooled
        cache["img_pooled_op"] = img_memory[:, 0]
    return cache


def _inputs(seed=3, B=2, H=160, W=224, T=12):
    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (B, H, W, 3), generator=g,
                           dtype=torch.uint8)
    image_mask = torch.zeros(B, H, W, dtype=torch.bool)
    image_mask[1, 128:] = True
    image_mask[1, :, 160:] = True
    text_ids = torch.full((B, T), 1, dtype=torch.int32)
    text_ids[0, :9] = torch.randint(3, VOCAB, (9,), generator=g)
    text_ids[1, :5] = torch.randint(3, VOCAB, (5,), generator=g)
    return images, image_mask, text_ids, text_ids == 1


@pytest.mark.parametrize("contrastive", [False, True],
                         ids=["flagship", "contrastive_loss"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_split_encode_is_bit_equal_to_unsplit(contrastive, mode):
    cfg = dataclasses.replace(TINY, contrastive_loss=contrastive)
    torch.manual_seed(0)
    model = TOIST(cfg, text_vocab_size=VOCAB).to_compute_dtype()
    model.train(mode == "train")
    args = _inputs()

    def gen():
        return (torch.Generator().manual_seed(11) if mode == "train"
                else None)

    with torch.set_grad_enabled(mode == "train"):
        want = _unsplit_encode(model, *args, gen())
        got = model.encode(*args, gen())
    assert set(got) == set(want)
    assert ("text_pooled_op" in got) == contrastive
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert got[k].dtype == w.dtype, k
            assert torch.equal(got[k], w), k
        else:
            assert got[k] == w, k


def test_normalize_keeps_its_constants_on_the_device():
    images, image_mask, _, _ = _inputs()
    toist_mod._norm_constants.cache_clear()
    with torch.inference_mode():    # as the Predictor first calls it
        got = normalize_uint8_images(images, image_mask)
    want = _host_normalize(images, image_mask)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    scale, shift = toist_mod._norm_constants(images.device)
    assert scale.dtype == shift.dtype == torch.float32
    # made once, and usable outside inference mode (training)
    assert toist_mod._norm_constants(images.device)[0] is scale
    assert not scale.is_inference() and not shift.is_inference()
    assert torch.equal(scale, torch.as_tensor(_NORM_SCALE))
    assert torch.equal(shift, torch.as_tensor(_NORM_SHIFT))


def test_cpu_predictor_runs_the_encoders_eagerly():
    from toist_tpu_torch.data import captions
    from toist_tpu_torch.data.batcher import collate
    from toist_tpu_torch.predict import Predictor
    from toist_tpu_torch.utils.convert import synth_reference_state_dict

    cfg = pconfig.Config.from_sources(None, {
        "model": {"backbone": "resnet18-test", "hidden_dim": 64,
                  "nheads": 4, "dim_feedforward": 128, "enc_layers": 1,
                  "dec_layers": 1, "num_queries": 10,
                  "compute_dtype": "float32",
                  "contrastive_align_loss": False, "dropout": 0.0,
                  "resizer_dropout": 0.0, "text_hidden": 64,
                  "text_layers": 1, "text_heads": 4,
                  "text_intermediate": 128},
        "data": {"image_buckets": [[96, 128], [128, 96]],
                 "max_text_len": 32, "max_boxes": 8, "max_size": 128,
                 "val_size": 96},
    })
    tokenizer = captions.build_tokenizer(cfg)
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=1, dec=1, d=64, dim_feedforward=128,
        text_layers=1, text_hidden=64, text_intermediate=128,
        num_queries=10, vocab_size=tokenizer.vocab_size, contrastive=False,
        with_masks=False, seed=2)
    port = Predictor.from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg, device="cpu",
        tokenizer=tokenizer)
    rng = np.random.default_rng(1)
    samples = [port.prepare(rng.integers(0, 256, (96, 120, 3), np.uint8), t)
               for t in (2, 9)]
    batch = collate(samples, port.spec, port.bucket(samples[0]),
                    batch_size=2)
    first = port.predict_batch(batch)
    second = port.predict_batch(batch)
    g = port.graphs
    assert (g.captures, g.replays, g.eager) == (0, 0, 2)
    assert g.by_key == {} and g.pool is None
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a["scores"], b["scores"])
    # Called directly, gradients on: eager too.
    args = tuple(torch.from_numpy(batch[k]) for k in
                 ("images", "image_mask", "text_ids", "text_mask"))
    out = g(*args)
    assert "img_tokens" in out and g.eager == 3
