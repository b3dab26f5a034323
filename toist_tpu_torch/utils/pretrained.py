"""Pretrained weights: torchvision ResNet, timm EfficientNet and Hugging
Face RoBERTa state dicts into the model.

Counterpart of ``toist_tpu/utils/pretrained.py``. The port keeps the
reference's parameter names, so each converter is a rename into the
reference layout (``backbone.0.body.*``, ``transformer.text_encoder.*``):

- ``convert_torchvision_resnet``: a bare ``resnet101().state_dict()``; the
  classifier (``fc.*``) and ``num_batches_tracked`` dropped, as the
  reference's IntermediateLayerGetter drops them;
- ``convert_timm_efficientnet``: a bare timm ``efficientnet_bX`` state
  dict; the head (``conv_head``, the top-level ``bn2``, ``classifier``)
  dropped, as ``features_only`` does (the port keeps timm's block names,
  ``models/efficientnet.py``);
- ``convert_hf_roberta``: a bare ``RobertaModel.state_dict()``; the pooler
  dropped unless ``keep_pooler`` (the CLS contrastive path), and HF's
  ``position_ids`` buffer.

``apply_pretrained`` loads the configured files into a model (f32, before
the compute-dtype cast), honouring ``model.without_pretrain``. A converted
tree must match the model's exactly (``_check_same_shapes``: missing or
extra names, or a shape, raise ``ValueError``). The backbone's
convolutions are parameters and its BatchNorm statistics buffers: the
buffers land only with ``backbone_norm="frozen_bn"``, and with GroupNorm
the parameters do not match (GroupNorm's scale and bias), as in JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

BACKBONE = "backbone.0.body."
TEXT = "transformer.text_encoder."
_BN_STATS = ("running_mean", "running_var")


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch ``.pth`` / ``.bin`` (a bare state dict, or one under
    "state_dict") or a numpy ``.npz`` of arrays, as CPU tensors."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "state_dict" in payload:
        payload = payload["state_dict"]
    return {k: v for k, v in payload.items() if torch.is_tensor(v)}


def convert_torchvision_resnet(state_dict: Mapping[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    return {BACKBONE + k: v for k, v in state_dict.items()
            if not k.startswith("fc.") and "num_batches_tracked" not in k}


def convert_timm_efficientnet(state_dict: Mapping[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    out = {BACKBONE + k: v for k, v in state_dict.items()
           if k.split(".")[0] in ("conv_stem", "bn1", "blocks")
           and "num_batches_tracked" not in k}
    if not any(k.startswith(BACKBONE + "blocks.") for k in out):
        raise ValueError("state_dict has no timm EfficientNet blocks.*")
    return out


def convert_hf_roberta(state_dict: Mapping[str, torch.Tensor],
                       keep_pooler: bool = False) -> Dict[str, torch.Tensor]:
    return {TEXT + k: v for k, v in state_dict.items()
            if not k.endswith("position_ids")
            and (keep_pooler or not k.startswith("pooler."))}


def _check_same_shapes(dst: Mapping[str, torch.Tensor],
                       src: Mapping[str, torch.Tensor], what: str) -> None:
    missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
    if missing or extra:
        raise ValueError(f"pretrained tree mismatch at {what}: "
                         f"missing={missing[:8]} extra={extra[:8]}")
    for k, v in dst.items():
        if tuple(v.shape) != tuple(src[k].shape):
            raise ValueError(f"pretrained shape mismatch at {k}: "
                             f"{tuple(src[k].shape)} vs {tuple(v.shape)}")


def _split_backbone(sd: Mapping[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """(convolutions, BatchNorm slots) of a converted backbone."""
    convs, norms = {}, {}
    for k, v in sd.items():
        slot = k.rsplit(".", 2)[-2]
        is_norm = (slot.startswith("bn") or k.endswith(_BN_STATS)
                   or ".downsample.1." in k)
        (norms if is_norm else convs)[k] = v
    return convs, norms


@torch.no_grad()
def apply_pretrained(cfg, model: torch.nn.Module) -> torch.nn.Module:
    """Overlay ``run.pretrained_backbone`` / ``run.pretrained_text`` onto
    ``model`` in place (``toist_tpu/utils/pretrained.py:155-182``); a no-op
    with ``model.without_pretrain``. Returns the model."""
    if cfg.model.without_pretrain:
        return model
    params = {n: p for n, p in model.named_parameters()}
    buffers = {n: b for n, b in model.named_buffers()}
    new: Dict[str, torch.Tensor] = {}
    if cfg.run.pretrained_backbone:
        sd = load_state_dict(cfg.run.pretrained_backbone)
        conv = (convert_timm_efficientnet(sd)
                if cfg.model.backbone.startswith("timm_")
                else convert_torchvision_resnet(sd))
        convs, norms = _split_backbone(conv)
        _check_same_shapes({k: v for k, v in params.items()
                            if k.startswith(BACKBONE)}, convs,
                           "params/backbone")
        new.update(convs)
        if cfg.model.backbone_norm == "frozen_bn":
            _check_same_shapes({k: v for k, v in buffers.items()
                                if k.startswith(BACKBONE)}, norms,
                               "frozen/backbone")
            new.update(norms)
    if cfg.run.pretrained_text:
        te = convert_hf_roberta(load_state_dict(cfg.run.pretrained_text),
                                keep_pooler=cfg.model.contrastive_loss)
        _check_same_shapes({k: v for k, v in params.items()
                            if k.startswith(TEXT)}, te,
                           "params/text_encoder")
        new.update(te)
    own = dict(params, **buffers)
    for k, v in new.items():
        own[k].copy_(v.to(own[k].dtype))
    return model
