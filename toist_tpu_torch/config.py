"""Typed configuration for the TPU-native TOIST framework.

The port's own copy of ``toist_tpu/config.py``, kept line for line so that it
diffs against it (the port imports nothing of the JAX package).

Replaces the reference's argparse (~70 flags, ``reference main.py:32-274``) plus the
JSON dataset-config dict-merge (``reference main.py:287-292``) with one frozen
dataclass tree and explicit precedence: defaults < config file < CLI overrides.

The reference silently lets ``configs/tdod.json`` override parsed flags; here the merge is
explicit (`Config.from_sources`) and unknown keys are errors.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (reference: main.py:104-160)."""

    backbone: str = "resnet101"          # reference --backbone (main.py:113-118)
    dilation: bool = False               # --dilation (main.py:104-112)
    hidden_dim: int = 256                # --hidden_dim (main.py:131-136)
    dropout: float = 0.1                 # --dropout (main.py:137)
    # The reference hardcodes the FeatureResizer's dropout at 0.1 regardless
    # of --dropout (transformer.py:473-492) — an explicit knob here instead of
    # inferring from `dropout`, so dropout=0 parity runs still match the
    # reference; fully deterministic runs (tests) set BOTH to 0.0.
    resizer_dropout: float = 0.1
    nheads: int = 8                      # --nheads (main.py:138-143)
    dim_feedforward: int = 2048          # --dim_feedforward (main.py:125-130)
    enc_layers: int = 6                  # --enc_layers (main.py:119-121)
    dec_layers: int = 6                  # --dec_layers (main.py:122-124)
    num_queries: int = 100               # --num_queries (main.py:144)
    # Dropped reference flags (documented, not silently ignored):
    #   --pre_norm: the reference decoder's pre-norm path is `assert False`
    #     (transformer.py:418) so the flag is unusable end to end.
    #   --no_pass_pos_and_query: setting it crashes the reference joint encoder
    #     (pos_embed becomes None before torch.cat, transformer.py:124,148).
    text_encoder_type: str = "roberta-base"  # --text_encoder_type (main.py:154-158)
    freeze_text_encoder: bool = False    # --freeze_text_encoder (main.py:146-153)
    without_pretrain: bool = False       # --without_pretrain (main.py:256):
                                         # ignore run.pretrained_* weight files
    num_classes: int = 255               # hardcoded (models/mdetr.py:1040); logits = 256 cols
    backbone_norm: str = "frozen_bn"     # frozen_bn (parity) | group_norm (from scratch)
    # Text encoder dims (roberta-base defaults; tests shrink these).
    text_hidden: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_intermediate: int = 3072
    contrastive_align_loss: bool = True  # inverse of --no_contrastive_align_loss
    contrastive_hdim: int = 64           # --contrastive_loss_hdim (main.py:179-185)
    contrastive_loss: bool = False       # --contrastive_loss (main.py:178): CLS token
                                         # prepended to the image sequence; pooled
                                         # text/image ops in memory_cache
                                         # (transformer.py:55,107-119,159-160)
    position_embedding: str = "sine"     # --position_embedding {sine, learned}
                                         # (position_encoding.py:89-99)
    mask_model: str = "none"             # --mask_model {none,smallconv} (main.py:164-169)
    masks: bool = False                  # derived: mask_model != none => True (main.py:297-298)
    frozen_detector: bool = False        # seg training freezes wrapped detector
    # Additions without a reference counterpart: the compute dtype policy and
    # rematerialization (torch.utils.checkpoint on the backbone blocks and the
    # encoder layers, the dropout generator restored for the recomputation).
    # It trades a second forward of those blocks for activation memory; its
    # step ms and peak memory on the H100 are in PERF.md (chip_smoke.py phase
    # 15(b)). Off by default, as in the JAX package.
    compute_dtype: str = "bfloat16"      # activations/matmul dtype
    param_dtype: str = "float32"
    remat: bool = False
    # Fused (flash-style) attention for the joint encoder self-attn and
    # decoder cross-attn (ops/flash_attention.py). "auto", "on" and
    # "interpret": the CUDA kernels for CUDA tensors, the plain version for
    # CPU tensors; "off": the plain version on any device.
    fused_attention: str = "auto"        # auto | on | off | interpret
    # Mask-head layout. "flat" is the reference shape ([B*N, h, w, c]). The
    # JAX package also keeps "folded" (MaskHeadSmallConvFolded: the query
    # axis folded into channels, the FPN adapters and lay1's shared half
    # computed once per image) and "folded_shifts" (the 3x3 convs as
    # shifted matmuls), built for the TPU's lane width; they hold the same
    # parameters and compute the same function (tests/test_segmentation.py).
    # The port builds the flat head for every layout (models/segmentation
    # .py), so a folded checkpoint loads into it unchanged, and the option
    # stays so that a JAX configuration parses unchanged. No layout's time
    # on the H100 is measured; the flat head's share of a seg step is in
    # PERF.md (chip_smoke.py phase 13).
    mask_head_layout: str = "flat"       # flat | folded | folded_shifts


@dataclass(frozen=True)
class DataConfig:
    """Dataset + static-shape batching config.

    The reference pads each batch to its own max shape (util/misc.py:184-209) and lets text
    pad to the longest caption (models/transformer.py:129). On TPU everything is padded to a
    small static set of buckets so XLA never recompiles (SURVEY.md §5.7).
    """

    coco_path: str = ""                  # root holding images + task_N_{train,test}.json
    refexp_ann_path: str = ""            # annotations dir (configs/tdod.json)
    tasks: Tuple[int, ...] = tuple(range(1, 15))  # COCO-Tasks task ids 1..14
    # Static shapes. Empty = use batcher.default_buckets (two-orientation
    # 800x1344 / 1344x800 canvases covering the 800/1333 resize envelope);
    # custom lists must cover BOTH orientations or portrait samples drop.
    # image_buckets is the EVAL canvas set (val resize is fixed short-side 800
    # so two canvases suffice); train_image_buckets is the TRAIN ladder —
    # empty = batcher.train_buckets, an 8-canvas ladder matching the
    # multiscale 480..800 resize so small-scale samples don't pad to the full
    # 832x1344 canvas (<=1.3x typical padding waste instead of ~3.6x, at a
    # budget of <=8 train-step compiles).
    image_buckets: Tuple[Tuple[int, int], ...] = ()
    train_image_buckets: Tuple[Tuple[int, int], ...] = ()
    max_text_len: int = 64               # static text token length (captions are short)
    num_logit_cols: int = 256            # positive-map width (datasets/tdod.py:152)
    max_boxes: int = 25                  # static per-image GT box slots + validity mask
    train_scales: Tuple[int, ...] = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)
    max_size: int = 1333
    val_size: int = 800                  # val short-side resize (datasets/tdod.py:330)
    # Caption modes (datasets/tdod.py:66-89)
    verb_noun_input: bool = False        # teacher captions "verb + noun"
    num_workers: int = 4
    # "thread" (GIL released by PIL/numpy) or "process" — real worker
    # processes like the reference DataLoader(num_workers, main.py:415-424).
    worker_mode: str = "thread"
    # Ship uint8 image canvases and normalize on-device (fused into the stem
    # input chain): bit-equivalent to host normalization (the geometric
    # transforms run on u8 PIL either way, like the reference whose Normalize
    # follows ToTensor) while moving 4x fewer host->device bytes and skipping
    # the host f32 pass. models/toist.py normalize_uint8_images; the model
    # accepts either dtype, so f32-normalized batches remain valid inputs.
    device_normalize: bool = True


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer / schedule (reference: main.py:47-74, util/optim.py)."""

    lr: float = 5e-5
    lr_backbone: float = 1e-5
    text_encoder_lr: float = 1e-5
    # Batch sizes are PER data-parallel device — the reference's per-GPU
    # semantics (scripts/train_dete.sh: batch 6 x 6 GPUs = global 36). The
    # training loop multiplies by the mesh's data-axis extent: the global train
    # step batch is train_batch_size * grad_accum_steps * n_data (main.py).
    train_batch_size: int = 6
    valid_batch_size: int = 8
    weight_decay: float = 1e-4
    epochs: int = 60
    lr_drop: int = 7
    optimizer: str = "adamw"
    clip_max_norm: float = 0.1
    ema: bool = True
    # Gradient accumulation: the train step consumes a batch of
    # grad_accum_steps * train_batch_size samples, scans microbatches of
    # train_batch_size accumulating gradients, and applies ONE optimizer
    # update — bitwise-equivalent normalization to the reference's
    # DDP-mean-of-ranks (per-microbatch losses normalized by
    # global_num_boxes / accum, grads averaged; mdetr.py:996-1001 +
    # engine.py:88). Lets a single chip (or a small mesh) reproduce the
    # reference's 6-GPU global batch (e.g. 6 x 6 = accum 6 at batch 6).
    # No reference flag — the reference scales only by adding GPUs.
    # Known deviation when combined with loss.cluster=True: the cluster bank
    # threads through the microbatch scan, so microbatch k's cluster/nsthl2
    # losses read a bank already updated by microbatches < k, whereas the
    # reference's DDP ranks all read the same per-step bank (each rank's
    # teacher inserts ride one all-gather, mdetr.py:62-103, before the student
    # losses). The gradient-equality test covers cluster=False
    # (tests/test_distillation.py); with cluster on, accumulation is an
    # approximation of the big-batch step, not a bitwise replica.
    grad_accum_steps: int = 1
    # AdamW first-moment dtype ("float32" | "bfloat16"). bfloat16 halves mu
    # HBM traffic/storage (~370 MB at flagship scale); f32 default matches
    # the reference's torch AdamW state exactly. (The second moment stays
    # f32 — its dynamic range drives update stability.)
    moment_dtype: str = "float32"
    ema_decay: float = 0.9998
    fraction_warmup_steps: float = 0.01
    schedule: str = "linear_with_warmup" # {step, multistep, linear_with_warmup, all_linear_with_warmup}
    eval_skip: int = 1


@dataclass(frozen=True)
class LossConfig:
    """Loss switches + coefficients (reference: main.py:186-250, models/mdetr.py:1067-1103)."""

    aux_loss: bool = True                # inverse of --no_aux_loss (main.py:86-92)
    set_cost_class: float = 1.0          # --set_cost_class (main.py:198-203)
    set_cost_bbox: float = 5.0           # --set_cost_bbox (main.py:204-209)
    set_cost_giou: float = 2.0           # --set_cost_giou (main.py:210-215)
    ce_loss_coef: float = 1.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    mask_loss_coef: float = 1.0
    dice_loss_coef: float = 1.0
    contrastive_align_loss_coef: float = 1.0
    eos_coef: float = 0.1                # --eos_coef (main.py:223-228)
    temperature_NCE: float = 0.07        # --temperature_NCE (main.py:193-197)
    # Distillation (main.py:232-250)
    nsthl2_loss: bool = False            # --nsthl2_loss
    nsthl2_coef: float = 1e4
    softkd_loss: bool = False            # --softkd_loss
    softkd_coef: float = 50.0
    cluster: bool = False                # --cluster
    cluster_choice_loss: float = 0.0
    cluster_feature_loss: float = 1e4
    cluster_memory_size: int = 1024
    cluster_num: int = 3                 # K for k-means
    fifo_memory: bool = False            # --fifo_memory
    distillation: bool = False           # --distillation (dual teacher/student)
    kmeans_max_iters: int = 32           # bounded lax.while_loop iters (kmeans.py:62-94 unbounded)
    kmeans_tol: float = 1e-4


@dataclass(frozen=True)
class RunConfig:
    """Runtime / orchestration."""

    output_dir: str = ""
    seed: int = 42
    resume: str = ""
    load: str = ""
    load_noun: str = ""
    # Pretrained-weight ingestion (the reference builds from torchvision
    # ImageNet ResNet-101 + HF roberta-base by default, backbone.py:83-91 /
    # transformer.py:59-64). Paths to .pth/.npz state dicts converted by
    # utils/pretrained.py; ignored when model.without_pretrain is set.
    pretrained_backbone: str = ""        # torchvision resnet101 state_dict
    pretrained_text: str = ""            # HF roberta-base state_dict
    start_epoch: int = 0
    eval_only: bool = False
    profile_dir: str = ""                # jax.profiler trace of the first epoch
    # Mesh: data parallelism is the reference's only strategy (SURVEY.md §2.2).
    # A 2-D mesh adds Megatron-style tensor parallelism over 'model'
    # (parallel/tp.py): mesh_shape=(-1, tp), mesh_axes=("data", "model").
    mesh_shape: Tuple[int, ...] = (-1,)  # -1 = remaining devices on that axis
    mesh_axes: Tuple[str, ...] = ("data",)
    shard_opt_state: bool = True         # ZeRO-1-style optimizer sharding over 'data'
    # Dropout-mask PRNG of the JAX package: "rbg" (XLA's RngBitGenerator)
    # or "threefry2x32". The port draws its masks from the step's
    # torch.Generator and the kernels' hash (ops/flash_attention.py): it
    # parses this option and does not read it, as it does
    # run.compile_cache_dir (the JAX package's TPU-only options, ROADMAP
    # queue A item 8).
    dropout_rng_impl: str = "rbg"
    # Background (async) checkpoint writes: the epoch loop hands the host
    # copy of the state to one writer thread (train/checkpoint.py).
    async_checkpoint: bool = True
    # Persistent XLA compilation cache directory ('' = ~/.cache/toist_tpu/
    # xla_cache; env TOIST_COMPILE_CACHE=off disables). Amortizes the train
    # ladder's per-bucket compiles across runs (utils/compile_cache.py).
    compile_cache_dir: str = ""
    # Eval-time losses: the reference computes the full criterion (incl. a
    # 6-level Hungarian solve) per eval batch purely for loss logging
    # (engine.py:300-305). False skips it — a serving-style fast path with
    # identical predictions/metrics, only the eval loss meters disappear.
    compute_eval_losses: bool = True


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)

    @staticmethod
    def from_sources(config_file: Optional[str] = None,
                     overrides: Optional[dict] = None) -> "Config":
        """defaults < json config file < overrides. Unknown keys raise."""
        cfg = Config()
        for source in (_load_json(config_file), overrides or {}):
            cfg = _merge(cfg, source)
        cfg = _derive(cfg)
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _load_json(path: Optional[str]) -> dict:
    if not path:
        return {}
    with open(path) as f:
        return json.load(f)


def _merge(cfg: Config, src: dict) -> Config:
    sections = {}
    for sec_name, sec_val in src.items():
        if not hasattr(cfg, sec_name):
            raise KeyError(f"Unknown config section: {sec_name!r}")
        sec = getattr(cfg, sec_name)
        if not isinstance(sec_val, dict):
            raise TypeError(f"Config section {sec_name!r} must be a dict")
        kwargs = {}
        for k, v in sec_val.items():
            if not hasattr(sec, k):
                raise KeyError(f"Unknown config key: {sec_name}.{k}")
            cur = getattr(sec, k)
            if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                v = tuple(tuple(x) if isinstance(x, (list, tuple)) else x for x in v)
            kwargs[k] = v
        sections[sec_name] = dataclasses.replace(sec, **kwargs)
    return dataclasses.replace(cfg, **sections) if sections else cfg


def _derive(cfg: Config) -> Config:
    """Derived flags, mirroring reference main.py:297-320 guards."""
    model = cfg.model
    if model.mask_model != "none" and not model.masks:
        model = dataclasses.replace(model, masks=True)
    if cfg.loss.cluster and cfg.loss.cluster_num <= 0:
        raise ValueError("cluster_num must be positive when cluster is enabled")
    if cfg.loss.distillation and not (cfg.loss.softkd_loss or cfg.loss.nsthl2_loss
                                      or cfg.loss.cluster):
        raise ValueError("distillation requires at least one distillation loss")
    return dataclasses.replace(cfg, model=model)
