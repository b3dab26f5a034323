"""The TOIST model: backbone + text encoder + joint encoder + query decoder +
heads.

Counterpart of ``toist_tpu/models/toist.py``, with the two seams kept:
``encode`` -> memory_cache dict (batch-first), ``decode`` -> {pred_logits,
pred_boxes, aux_*, proj_*}; ``forward`` runs both. Parameter names are the
reference checkpoint's, so a reference-layout state dict loads with
``load_state_dict``.

Compute dtype: the trunk (backbone, input_proj, text encoder, resizer, joint
transformer) runs in ``cfg.compute_dtype`` after ``to_compute_dtype()``; the
class/box heads and contrastive projections run in f32 on an f32 copy of the
decoder output, as in the JAX package. With ``cfg.masks`` the mask branch
(``bbox_attention``, ``mask_head``; ``compute_masks``) joins the trunk's
cast, and the head's last convolution stays f32. Backbone features in the
cache are NCHW (channels_last memory); token tensors are [B, S, D].

Training mode (``.train()``) drops as the JAX model does with
``deterministic=False``; ``encode``, ``decode`` and ``forward`` then take the
step's ``generator`` (the JAX model's "dropout" rng). ``cfg.remat``
recomputes the backbone blocks and the encoder layers in the backward;
``cfg.fused_attention="off"`` routes every attention through the plain
version on any device ("auto", "on" and "interpret" take the kernels for
CUDA tensors). ``input_proj`` and the mask head's adapters take the
backbone's channels (ResNet's 2048 / 1024, 512, 256, or EfficientNet's).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from toist_tpu_torch.config import ModelConfig
from toist_tpu_torch.models.joint_transformer import JointEncoder, QueryDecoder
from toist_tpu_torch.models.layers import (MLP, FeatureResizer,
                                           set_fused_attention)
from toist_tpu_torch.models.position_encoding import (
    LearnedPositionEmbedding2D, SinePositionEmbedding)
from toist_tpu_torch.models.resnet import Backbone, downsample_mask
from toist_tpu_torch.models.segmentation import (MaskHeadSmallConv,
                                                 MHAttentionMap)
from toist_tpu_torch.models.text_encoder import RobertaEncoder

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def normalize_uint8_images(images: torch.Tensor,
                           image_mask: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of raw u8 canvases [B, H, W, 3] on the device:
    the same f32 ``x * scale - shift`` affine as the host path, padded pixels
    forced to 0."""
    from toist_tpu_torch.data.transforms import _NORM_SCALE, _NORM_SHIFT

    scale = torch.as_tensor(_NORM_SCALE, device=images.device)
    shift = torch.as_tensor(_NORM_SHIFT, device=images.device)
    keep = (~image_mask)[..., None].float()
    return (images.float() * scale - shift) * keep


class _Transformer(nn.Module):
    """The reference's ``transformer.*`` namespace."""

    def __init__(self, cfg: ModelConfig, text_vocab_size: int):
        super().__init__()
        d = cfg.hidden_dim
        self.encoder = JointEncoder(d, cfg.nheads, cfg.enc_layers,
                                    cfg.dim_feedforward, cfg.dropout,
                                    cfg.remat)
        self.decoder = QueryDecoder(d, cfg.nheads, cfg.dec_layers,
                                    cfg.dim_feedforward, cfg.dropout)
        self.resizer = FeatureResizer(cfg.text_hidden, d,
                                      cfg.resizer_dropout)
        self.text_encoder = RobertaEncoder(
            vocab_size=text_vocab_size, hidden_size=cfg.text_hidden,
            num_layers=cfg.text_layers, num_heads=cfg.text_heads,
            intermediate_size=cfg.text_intermediate, dropout=cfg.dropout,
            add_pooler=cfg.contrastive_loss)
        # CLS token prepended to the image sequence (--contrastive_loss).
        self.CLS = nn.Embedding(1, d) if cfg.contrastive_loss else None


class TOIST(nn.Module):
    def __init__(self, cfg: ModelConfig, text_vocab_size: int = 50265):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        d = cfg.hidden_dim
        pos = (LearnedPositionEmbedding2D(d // 2)
               if cfg.position_embedding == "learned"
               else SinePositionEmbedding(d // 2))
        body = Backbone(cfg.backbone, cfg.dilation, cfg.backbone_norm,
                        cfg.remat)
        self.backbone = nn.ModuleList([body, pos])
        chans = body.body.channels
        self.input_proj = nn.Conv2d(chans["layer4"], d, 1)
        self.transformer = _Transformer(cfg, text_vocab_size)
        self.query_embed = nn.Embedding(cfg.num_queries, d)
        self.class_embed = nn.Linear(d, cfg.num_classes + 1)
        self.bbox_embed = MLP(d, d, 4, 3)
        if cfg.contrastive_align_loss:
            h = cfg.contrastive_hdim
            self.contrastive_align_projection_image = nn.Linear(d, h)
            self.contrastive_align_projection_text = nn.Linear(d, h)
        if cfg.masks:
            # Every mask_head_layout builds the flat head (segmentation.py).
            self.bbox_attention = MHAttentionMap(d, cfg.nheads)
            self.mask_head = MaskHeadSmallConv(
                d + cfg.nheads, d,
                [chans[f"layer{i}"] for i in (3, 2, 1)])
        if cfg.fused_attention == "off":
            set_fused_attention(self, False)

    @classmethod
    def from_state_dict(cls, state_dict: Mapping[str, torch.Tensor],
                        cfg: ModelConfig, device="cuda") -> "TOIST":
        """Build, load a reference-layout state dict (strict), move to
        ``device`` (the card unless the caller asks for another), cast the
        trunk to the compute dtype, and set eval mode."""
        vocab = state_dict[
            "transformer.text_encoder.embeddings.word_embeddings.weight"
        ].shape[0]
        with torch.device(device):   # initialise on the device: faster
            model = cls(cfg, text_vocab_size=vocab)
        model.load_state_dict(state_dict)
        return model.to_compute_dtype().eval()

    def to_compute_dtype(self) -> "TOIST":
        """Cast the trunk and the mask branch to the compute dtype
        (convolutions channels_last); the class / box heads, the
        contrastive projections and the mask head's ``out_lay`` stay
        f32."""
        dt = self.compute_dtype
        for m in (self.backbone, self.input_proj):
            m.to(dtype=dt, memory_format=torch.channels_last)
        self.transformer.to(dt)
        if self.cfg.masks:
            self.bbox_attention.to(dt)
            self.mask_head.to(dtype=dt, memory_format=torch.channels_last)
            self.mask_head.out_lay.float()
        return self

    def encode(self, images: torch.Tensor, image_mask: torch.Tensor,
               text_ids: torch.Tensor, text_mask: torch.Tensor,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """images [B,H,W,3] u8 (normalized here) or f32 normalized;
        image_mask [B,H,W] True = pad; text_ids [B,T] int; text_mask [B,T]
        True = pad. Returns the memory cache."""
        cfg, dt = self.cfg, self.compute_dtype
        d = cfg.hidden_dim
        if images.dtype == torch.uint8:
            images = normalize_uint8_images(images, image_mask)
        x = images.to(dt).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        feats = self.backbone[0](x, pad_mask=image_mask)
        src = feats["layer4"]
        B, _, fh, fw = src.shape
        fmask = downsample_mask(image_mask, fh, fw)
        pos = self.backbone[1](fmask, dt)                    # [B, fh, fw, d]
        src = self.input_proj(src)                           # [B, d, fh, fw]

        img_tokens = src.permute(0, 2, 3, 1).reshape(B, fh * fw, d)
        pos_tokens = pos.reshape(B, fh * fw, d)
        img_token_mask = fmask.reshape(B, fh * fw)

        tr = self.transformer
        text_pooled = None
        if cfg.contrastive_loss:
            cls_tok = tr.CLS.weight.to(dt)[None].expand(B, 1, d)
            img_tokens = torch.cat([cls_tok, img_tokens], dim=1)
            pos_tokens = torch.cat([pos_tokens.new_zeros(B, 1, d),
                                    pos_tokens], dim=1)
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
            "text_memory": img_memory[:, -T:],
            "img_memory": img_memory,
            "mask": joint_mask,
            "text_attention_mask": text_mask,
            "pos_embed": joint_pos,
            "feature_hw": (fh, fw),
            "features_c2": feats["layer1"],
            "features_c3": feats["layer2"],
            "features_c4": feats["layer3"],
            "src_proj": src,
            "feature_mask": fmask,
        }
        if cfg.contrastive_loss:
            cache["text_pooled_op"] = text_pooled
            cache["img_pooled_op"] = img_memory[:, 0]
        return cache

    def decode(self, memory_cache: Dict[str, torch.Tensor],
               use_modified_memory: bool = False,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """Decoder over the (possibly modified) memory, then the heads."""
        mem_key = "img_memory_mod" if use_modified_memory else "img_memory"
        memory = memory_cache[mem_key]
        B = memory.shape[0]
        dt = self.compute_dtype
        query_pos = self.query_embed.weight.to(dt)[None].expand(
            B, -1, -1)
        tgt = torch.zeros_like(query_pos)
        hs = self.transformer.decoder(tgt, memory, query_pos,
                                      memory_cache["pos_embed"],
                                      memory_cache["mask"], generator)
        hs32 = hs.float()
        outputs_class = self.class_embed(hs32)           # [L, B, Q, C+1]
        outputs_coord = torch.sigmoid(self.bbox_embed(hs32))
        out = {
            "pred_logits": outputs_class[-1],
            "pred_boxes": outputs_coord[-1],
            "aux_pred_logits": outputs_class[:-1],
            "aux_pred_boxes": outputs_coord[:-1],
            "hs": hs32,
        }
        if self.cfg.contrastive_align_loss:
            pq = self.contrastive_align_projection_image(hs32)
            pt = self.contrastive_align_projection_text(
                memory_cache["text_memory"].float())
            pq = pq / pq.norm(dim=-1, keepdim=True).clamp(min=1e-6)
            pt = pt / pt.norm(dim=-1, keepdim=True).clamp(min=1e-6)
            out["proj_queries"] = pq[-1]
            out["proj_tokens"] = pt
            out["aux_proj_queries"] = pq[:-1]
        return out

    def compute_masks(self, memory_cache: Dict[str, torch.Tensor],
                      hs_last: torch.Tensor,
                      query_idx: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Per-query stride-4 mask logits (reference segmentation.py:
        156-167). hs_last: [B, Q, D], the last decoder layer; query_idx:
        an optional [B, N] selection of queries (training runs only the
        matched ones; None = all). Reads ``img_memory``, never the
        cluster-snapped ``img_memory_mod``. Returns [B, N or Q, H/4, W/4]
        f32 logits."""
        src = memory_cache["src_proj"]                     # [B, D, fh, fw]
        B, D, fh, fw = src.shape
        off = 1 if self.cfg.contrastive_loss else 0        # the CLS slot
        memory = memory_cache["img_memory"][:, off:off + fh * fw].reshape(
            B, fh, fw, D)
        if query_idx is not None:
            sel = query_idx.clamp(0, hs_last.shape[1] - 1).long()
            hs_last = torch.gather(hs_last, 1,
                                   sel[..., None].expand(-1, -1, D))
        N = hs_last.shape[1]
        att = self.bbox_attention(hs_last, memory,
                                  memory_cache["feature_mask"])
        x = torch.cat([src.repeat_interleave(N, dim=0),
                       att.reshape(B * N, self.cfg.nheads, fh, fw).to(
                           src.dtype)], dim=1)
        logits = self.mask_head(x, memory_cache["features_c4"],
                                memory_cache["features_c3"],
                                memory_cache["features_c2"], num_queries=N)
        return logits.reshape(B, N, logits.shape[2], logits.shape[3]).float()

    def forward(self, images, image_mask, text_ids, text_mask,
                generator: Optional[torch.Generator] = None):
        cache = self.encode(images, image_mask, text_ids, text_mask,
                            generator)
        return self.decode(cache, generator=generator), cache
