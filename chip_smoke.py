#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (toist_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, each of which raises on failure (non-zero exit):
  1. device: the card's name and power limit, and whether nvcc, triton and
     PIL are present;
  2. build: the hand-written CUDA kernels (flash-attention forward and its
     dK/dV and dQ backward, each on the tensor cores for bf16 and on scalar
     FMAs for f32, with in-kernel dropout; the LSA solver), one nvcc per
     source, all started together, from toist_tpu_torch/csrc into
     build/kernels; each kernel's registers, shared memory and spills as
     ptxas reports them (flash_fwd_tc_kernel among them; every
     instantiation of the LSA kernel, which must not spill);
  3. kernel vs plain: the flash-attention forward against its plain PyTorch
     version at the slice's shapes (encoder self-attention [8,S,256] and
     decoder cross-attention [8,100,256] over [8,S,256], 8 heads, S = 1114
     on the 800x1344 serving canvas and 1156 on 832x1344), with
     and without a key padding mask, in f32 (TF32 off, atol 2e-5; the
     scalar kernel) and bf16 (atol/rtol 3e-2; the tensor-core kernel), and
     within 5e-5 (f32) and 1.5e-2 (bf16) of the output's max abs against
     the plain version in f32 on the same inputs; LSE within 1e-5
     relative; each launch checked for its route;
  4. slice at full width: the serving path (Predictor -> TOIST encode/decode
     -> postprocess_boxes) with ResNet-101, RoBERTa-base and a 6+6-layer
     d256 transformer in bf16, weights random from a seed in the reference
     checkpoint's layout, answering batches of 8 on the 800x1344 and
     1344x800 canvases; every forward must launch the tensor-core forward
     12 times;
  5. slice kernel vs plain: the same weights in f32 (TF32 off) on one batch,
     once through the kernel and once through the plain attention;
     pred_logits and pred_boxes must agree within 2e-3;
  6. attention backward and dropout vs plain: at the training shapes
     (encoder [6,1156,256], decoder cross [6,100,256] over [6,1156,256], and
     the 480x800 rung [6,439,256]) in f32 and bf16 with a fully masked row,
     forward and dQ/dK/dV against autograd through the plain version given
     the kernels' own dropout mask, at rate 0 and 0.1 (f32 within 5e-5 and
     bf16 within 1.5e-2 of each tensor's max abs; the fully masked row's dQ
     and dK exactly 0); bf16 runs the tensor-core kernels and f32 the
     scalar ones (route counters); the same seed reproduces bit for bit;
     the kernels' dropout mask equals dropout_keep_mask_plain (numpy) bit
     for bit and its kept share lies within 1e-3 of 1 - 26/256;
  7. LSA vs plain: [36,25,100] (continuous, padded rows, ties, NaN/inf
     rows), [36,100,100] random and [36,100,100] shaped like distillation's
     softkd re-pairing (ops/lsa.softkd_like_costs: n_fp 90-99, the 1e6
     columns, near-ties) against the plain version (equal assignments) and
     scipy (equal assignments on continuous costs, equal total cost on ties
     and the softkd case); the plain solver's host-clock ms, the kernel's
     bytes bound and the dependent steps of the longest problem
     (lsa_scan_steps); after phase 9, the same for the matcher's real
     [36,25,100] costs of phase 8's first batch (its fixture's few valid
     targets per image);
  8. training at full width: fixture data (toist_tpu_torch.data.fixtures)
     through BatchIterator on the batcher.train_buckets canvases, bf16 with
     f32 master weights, batch 6, dropout 0.1, one warm-up step and then an
     epoch through train_one_epoch / make_train_step; every loss finite,
     12 forward, 12 dK/dV, 12 dQ attention launches (all 36 on the
     tensor-core route) and 1 LSA launch per step, trainable parameters
     changed, frozen ones not, the EMA moved; step ms, img/s and peak
     memory; then torch.profiler over 3 steps on the largest canvas: device
     kernel ms per step by kind against unprofiled step ms (busy share);
  9. one training step with the kernels vs one without, in f32, dropout 0
     (the scalar forward and backward route). The run without kernels uses
     the plain attention and takes the criterion to the CPU (plain LSA). The
     LSA kernel and the plain solver give equal assignments on the same costs;
     a problem that the two runs match differently must be a near-tie (the
     two assignments' costs within 1e-4: a random model's queries predict
     near-equal boxes); held to one matching, the losses agree within 1e-4
     relative and the gradients within 2e-3 of each tensor's max abs,
     except the two whose gradient is 0 by construction (RoBERTa's key
     biases and the first decoder self-attention's in_proj_weight; rounding
     noise in both runs), which stay below 1e-4 of their module's other
     parameter's gradient;
 10. kernel times, one method for all (device_ms: CUDA events around 20
     calls queued behind a spin kernel, so that the host's launch work is
     left out; the median of 5 runs): the device ms per call of every
     hand-written kernel, of its plain version and of PyTorch's
     scaled_dot_product_attention on the same inputs (the library
     yardstick, which the port never calls):
     the forward at the serving shapes, and the forward, dK/dV and dQ at
     rate 0 and 0.1 at the training shapes, in bf16 and, at the encoder
     shapes, in f32 (the scalar route); what rate 0.1 adds to each kernel;
     the LSA kernel on phase 7's continuous, 100x100, softkd and real
     matcher costs, with the steps of the longest problem and the ns per
     step. Beside each, the kernel's bound and, for the forward, the exp2
     floor of the card's special-function units;
 11. the user's entry point: toist_tpu_torch.main from parse_args at full
     width in bf16 on the fixture (2 tasks x 30 images per split), the
     seeded weights given through --load (word embeddings cut to the
     fixture tokenizer's vocabulary). Run 1 trains one epoch of batch 6,
     writes checkpoint, evaluates the EMA (batch 8, eval_skip 1, the
     800x1344 canvas) and writes BEST_checkpoint; run 2 is --eval --resume
     <out>/checkpoint. Every eval forward launches the tensor-core forward
     12 times, the f32 route never, and 1 LSA (the eval losses); every
     training step launches what phase 8 counts; log.jsonl holds
     train_step, epoch and eval records; the mean AP@0.5 is finite; the
     resumed masters, AdamW moments and step counts, EMA and step equal run
     1's bit for bit; run 2's first eval batch's detections lie within 1.5e-2
     of the max abs of run 1's. It prints eval img/s (host clock from the
     second batch to evaluate's return), the mean AP@0.5 of random weights
     (a smoke value) and each checkpoint's size, host-copy and write
     seconds.

 12. noun-pronoun distillation through toist_tpu_torch.main at full width
     in bf16 on the fixture: run 1 trains one epoch of 3 pairs per step
     (the student from phase 11's seeded weights by --load, the teacher
     from phase 11's checkpoint by run.load_noun; softkd coef 50, nsthl2,
     the cluster bank [14, 1024, 256] with K 3 and 32 k-means iterations;
     dropout 0.1), writes checkpoint (student, teacher, both EMAs, AdamW
     over both, the bank), runs the cluster eval (batch 4, 800x1344) and
     writes BEST_checkpoint; run 2 is --eval --resume <out>/checkpoint.
     Every training step launches 24 forward, 24 dK/dV and 24 dQ
     tensor-core attention kernels and 3 LSA (the noun and sth matchers,
     the softkd re-pairing), every eval batch 12 forwards and 1 LSA; every
     loss is finite (softkd and its 5 aux levels, nsthl2, the cluster
     feature loss among them); the bank grows by the valid noun samples of
     each step; the cluster bank's entry points run under
     torch.cuda.set_sync_debug_mode("error"), so a host sync there fails
     the run; both models' trainable parameters change and their frozen
     ones do not, and both EMAs move; run 2's state equals run 1's bit for
     bit. It prints step ms, pairs/s and peak memory; torch.profiler over
     3 steps (kernel ms by kind, launches, busy share); the bank's calls
     replayed on the last step's inputs (launches, kernel and host ms; one
     k-means call's launches, times the 6 per step); the cluster-eval
     img/s; each checkpoint's size, copy and write seconds. Then one f32
     distillation step (dropout 0; phase 11's seeded student, a teacher
     from the next seed, run 1's bank) with the kernels against the same
     step with the plain attention and the plain LSA: each solve's kernel
     assignment against the plain solver on the same costs (equal, or
     equal total cost on ties for softkd), one matching for both runs (a
     problem matched otherwise must be a near-tie, 1e-4), losses within
     1e-4 relative (of at least 1e-3: softkd between two random models
     is a KL of 2e-6) and both models' gradients within 2e-3 of each
     tensor's max abs, or twice its f32 floor (the plain step's distance
     from the same step with f64 attention) where that is larger. The first
     training step's real [18,100,100] softkd costs go through phase 7's
     LSA check and phase 10's timing. Last, the port's ablation module
     (toist_tpu_torch.scripts.fixture_distill_ablation: f32 with no TF32,
     deterministic algorithms) runs in two processes at once on the card:
     their teacher, plain and distilled checkpoints must be equal bit for
     bit (the digests in each run's JSON); the teacher's, the plain and the
     distilled student's AP@0.5 and the margin are printed beside the CPU
     gate's floor of 0.015 (the gate itself is a CPU test; at this scale
     the margin's sign is noise in the JAX package too).
 13. segmentation through toist_tpu_torch.main at full width in bf16 on
     the fixture (the mask head at 264 input channels). Run 1 is
     train_seg (scripts/train_seg.sh): phase 11's detection checkpoint by
     --load (its contrastive projections dropped, the mask head's fresh
     init kept), model.frozen_detector, batch 2, loss.aux_loss=false, one
     epoch, checkpoint, bbox + segm eval (batch 4, 800x1344),
     BEST_checkpoint; run 2 is eval_seg (--eval --resume); run 3 is
     train_seg_dis then eval_seg_dis (phase 12's checkpoint by --load,
     loss.cluster=true, the bank's calls under set_sync_debug_mode
     ("error")). Every frozen-detector step launches 12 tensor-core
     forwards (with dropout), no dK/dV or dQ and 1 LSA, every eval batch 12
     forwards and 1 LSA; loss_mask and loss_dice are finite; only
     bbox_attention.* and mask_head.* train, every other parameter stays
     bit for bit, the EMA moves; each eval has segm stats for both tasks
     and log.jsonl its map@0.5_masks; the resumed state equals run 1's bit
     for bit and run 2's first mask logits lie within 1.5e-2 of run 1's.
     Then one eval batch of 4 at 800x1344 in f32 through the kernels and
     through the plain attention (mask logits, class logits and boxes
     within 2e-3; the LSA kernel's matching equal to the plain solver's on
     the same costs; the card's postprocess_masks_device equal to the same
     function on the CPU on the same logits except at knife-edge pixels),
     and Predictor with a mask head on 4 images (an RLE of the original
     size for every kept box). It prints the seg step ms, img/s and peak
     memory, torch.profiler over 3 steps (kernel ms by kind, the mask head
     forward's span), the seg eval img/s split into the eval step, the
     device postprocess (CUDA events), copy and host RLE ms per batch and
     the overflowing samples, and each checkpoint's size;
 14. data parallel through torchrun (``--standalone``, from the repository
     root), the flagship model at full width in bf16, dropout 0.1, the
     seeded weights by --load: (a) one rank on NCCL, one epoch of batch 6
     (run.shard_opt_state on; ZeRO-1 applies from two ranks), checkpoint
     and eval, then ``torchrun -m toist_tpu_torch.main --eval --resume``
     of its checkpoint with the same eval; (b) two ranks sharing the card
     on gloo (NCCL refuses two ranks on one device): plain detection
     (batch 6 per rank), distillation (3 pairs per rank) and segmentation
     (batch 2 per rank, from (b)'s plain checkpoint) on a fixture of 12
     images per split, each one epoch with its eval. The ranks run
     ``chip_smoke.py --rank-worker <spec>``, which calls
     toist_tpu_torch.main with hooks: every rank's train steps launch
     what phases 8, 12 and 13 count per step, every eval batch 12
     forwards and 1 LSA; the ranks' f32 masters and banks are equal bit
     for bit (all-gathered digests); each merged eval equals a one-process
     --eval --resume of the run's checkpoint; ZeRO-1 holds 0.35-0.65 of
     (a)'s moment bytes per rank. It prints per run the step ms, img/s,
     the gradient all-reduce's ms per step (CUDA events), the moment bytes
     per rank and the host seconds of main's parts.
 15. the rest of the JAX package's modes, at full width in bf16: (a)
     toist_tpu_torch.main with model.backbone=timm_tf_efficientnet_b3_ns
     (MDETR's published B3 backbone), fresh, with run.pretrained_backbone
     and run.pretrained_text (a timm B3 and a Hugging Face roberta-base
     state dict, random from a seed in their own layouts) and
     run.profile_dir: one epoch of batch 6 on a 2 x 12 fixture and the eval
     at batch 8; the files' tensors in the model bit for bit before the
     first step, 12 / 12 / 12 / 1 launches per step and 12 + 1 per eval
     batch, one trace file and one [profile] line; then
     Predictor.from_checkpoint of its checkpoint on 8 images, visualize of
     it (min(20, images) PNGs), and one f32 eval batch through the kernels
     against the plain attention (2e-3). (b) model.remat on the flagship:
     bf16 steps at batch 6 on 832x1344 with and without remat on the same
     batches (18 / 12 / 12 / 1 launches per step with remat; step ms and
     peak memory beside phase 8's), and one f32 step at rate 0.1 with
     remat against one without on the same generator (losses 1e-4,
     gradients 2e-3). (c) tensor parallelism: torchrun of 2 ranks sharing
     the card on gloo as a (1, 2) ('data', 'model') grid, plain detection
     at batch 6 per data group on phase 14's fixture, one epoch and the
     eval; 12 / 12 / 12 / 1 launches per rank and step, every forward at 4
     heads over D = 128, the replicated f32 masters equal bit for bit
     across the ranks, and the consolidated checkpoint in one process on
     an f32 batch against the TP ranks' f32 forward (2e-3); it prints the
     step ms, the model group's all-reduces per step (count and bytes), the
     moment bytes per rank and the host seconds of main's parts. Phases 3
     and 10 also hold and time the kernels at a TP rank's shapes, [6, 1156,
     128] with 4 heads and the decoder cross [6, 100, 128] over 1156 keys.
 16. the parity runner (toist_tpu_torch.scripts.run_parity --fixture) with
     the flagship model (ResNet-101, d 256, 8 heads, FFN 2048, 6+6 layers,
     100 queries, RoBERTa-base widths, bf16) and the published canvases on
     its fixture data (2 tasks x 3 images per split): synthetic reference
     .pth files at those widths, each audited against the model, then the
     five BASELINE configs (dete_task1, dete_all14, seg, noun: --eval
     --load; distill: one epoch of 2 pairs per step from the same
     checkpoint as student and teacher, with its cluster eval), each in its
     own process started by run_parity (chip_smoke.py --parity-worker runs
     toist_tpu_torch.main with launch counters). Every config exits 0 with
     finite per-task APs; every eval batch launches 12 tensor-core
     forwards and 1 LSA, every distillation step 24 / 24 / 24 tensor-core
     attention kernels (72 with dropout) and 3 LSA. It prints per config
     the per-task AP@0.5, the seconds and the launches.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. There is no CPU path.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
B, H, D = 8, 8, 256        # eval batch, attention heads, d_model
NUM_QUERIES = 100
TOL = {"float32": (2e-5, 0.0), "bfloat16": (3e-2, 3e-2)}   # (atol, rtol)
# Largest error over the tensor's max abs against the plain version in f32
# on the same inputs (phases 3 and 6). bf16: the kernels round P and dS to
# bf16 and the outputs to bf16 (at most 7.8e-3 measured), so 1.5e-2 fails
# a kernel that is 5% off, such as one that leaves out the dropout scale.
REL_TOL = {"float32": 5e-5, "bfloat16": 1.5e-2}
SLICE_TOL = 2e-3
LAUNCHES_PER_FORWARD = 12   # 6 encoder self-attn + 6 decoder cross-attn
TRAIN_B = 6                 # optim.train_batch_size
DROP_RATE = 0.1
LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 2e-3
# H100 SXM peaks at the full 700 W (NVIDIA's data sheet): dense bf16 tensor
# cores, f32 outside the tensor cores (the f32 kernels' scalar FMAs), HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12
# Matrix products of 2*B*Sq*S*D FLOP each: forward QK^T, PV; dK/dV kernel
# QK^T, dO V^T, P~^T dO, dS^T Q; dQ kernel QK^T, dO V^T, dS K.
PRODUCTS = {"fwd": 2, "dkv": 4, "dq": 3}
# exp2 per clock per SM of the special-function units (NVIDIA's table of
# arithmetic instruction throughput, compute capability 9.0).
EX2_PER_CLOCK_PER_SM = 16
CARD = {}   # SM count and maximum SM clock, read in phase 1


def log(*a):
    print(*a, flush=True)


def device_ms(fn, iters=20, repeats=5):
    """Device ms per call of fn: CUDA events around iters calls that the
    host queued behind a spin kernel (torch.cuda._sleep) long enough to
    hold the card until all of them are queued, so the card runs them back
    to back and the host's launch work is left out; the median of repeats
    such runs. A run whose start event had passed before the host had
    queued the last call (the card waited for the host) is taken again
    behind a spin twice as long."""
    import statistics

    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int((2 * host_s + 1e-3) * CARD["max_sm_mhz"] * 1e6)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    while len(runs) < repeats:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        waited = start.query()      # the card reached the calls first
        torch.cuda.synchronize()
        if waited:
            cycles *= 2
            if cycles > 2e10:       # about 10 s: fn waits for the card
                raise AssertionError("device_ms: the calls wait for the "
                                     "card, so their time is the host's")
            continue
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False); the port's smoke run needs one card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    CARD["max_sm_mhz"] = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    try:
        import PIL  # noqa: F401
        has_pil = True
    except ImportError:
        has_pil = False
    log(f"[device] {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | nvcc {shutil.which('nvcc') or 'absent'} | "
        f"triton {'present' if has_triton else 'absent'} | "
        f"PIL {'present' if has_pil else 'absent'} | {CARD['sms']} SMs, "
        f"max SM clock {CARD['max_sm_mhz']} MHz")
    return smi, has_pil


def ptxas_report(text):
    """{kernel<dtype,hd>: {registers, smem_bytes, spill_store_bytes}} from
    the compiler's -Xptxas -v output."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"_cu_[0-9a-f]{8}\d+([A-Za-z_]\w*?kernel)",
                             mangled)
            name = base.group(1) if base else mangled
            args = re.search(r"kernelI(\w*?)Li(\d+)E(?:Lb([01])E)?",
                             mangled)
            if name.startswith("lsa") and args:   # <int K>, 0: shared memory
                name += f"<K={args.group(2)}>"
            elif args:   # <typename T, int HD>, or <int HD, bool DROP> (bf16)
                dt = {"f": "f32,", "": "bf16,"}.get(args.group(1), "bf16,")
                drop = {"1": ",dropout", "0": ",no dropout"}.get(
                    args.group(3), "")
                name += f"<{dt}{args.group(2)}{drop}>"
            out[name] = {}
        elif name and "bytes spill stores" in line:
            for kind in ("store", "load"):
                out[name][f"spill_{kind}_bytes"] = int(
                    re.search(rf"(\d+) bytes spill {kind}s", line).group(1))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def phase_build():
    from toist_tpu_torch.ops import _build, lsa
    from toist_tpu_torch.ops.flash_attention import KERNEL_SOURCES

    sources = KERNEL_SOURCES + (lsa.KERNEL_SOURCE,)
    t0 = time.perf_counter()
    _build.load_libraries(sources)
    secs = {src: _build.BUILD_SECONDS[src] for src in sources}
    log(f"[build] {json.dumps(secs)}, wall {time.perf_counter() - t0:.2f} s")
    ptxas = {}
    for src in sources:
        if src not in _build.BUILD_LOG:
            log(f"[build] {src} was built before this run: no ptxas report")
        ptxas.update(ptxas_report(_build.BUILD_LOG.get(src, "")))
    for name, rep in ptxas.items():
        log(f"[build] ptxas {name}: {json.dumps(rep)} (static smem; the "
            f"f32 backward kernels take theirs dynamically)")
    if secs.get("flash_attn_fwd_tc.cu") and not any(
            n.startswith("flash_fwd_tc_kernel") for n in ptxas):
        raise AssertionError("no ptxas report of flash_fwd_tc_kernel")
    lsa_rep = {n: r for n, r in ptxas.items() if n.startswith("lsa_kernel")}
    if secs.get(lsa.KERNEL_SOURCE) and (len(lsa_rep) != 5 or any(
            r.get("spill_store_bytes", 1) or r.get("spill_load_bytes", 1)
            for r in lsa_rep.values())):
        raise AssertionError(f"LSA kernel: five instantiations without "
                             f"spills expected, ptxas says {lsa_rep}")
    return secs, ptxas


def attention_bound(kind, b, sq, s, dtype_name, d=D, h=H):
    """(bound ms, "operations" or "bytes") of one attention kernel call:
    its products over the card's peak rate for the dtype, against its
    inputs read once and outputs written once over the memory rate."""
    e = 2 if dtype_name == "bfloat16" else 4
    q_b, kv_b = b * sq * d * e, b * s * d * e
    rows_f32 = b * h * sq * 4                 # lse or D, [B, H, Sq] f32
    mask_b = b * s                            # key padding mask, u8
    nbytes = {"fwd": q_b + 2 * kv_b + mask_b + q_b + rows_f32,
              "dkv": 2 * q_b + 2 * kv_b + mask_b + 2 * rows_f32 + 2 * kv_b,
              "dq": 2 * q_b + 2 * kv_b + mask_b + 2 * rows_f32 + q_b}[kind]
    flops = PRODUCTS[kind] * 2 * b * sq * s * d
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def exp_bound(b, sq, s, h=H):
    """ms the card's special-function units take for one exp2 per score
    (b * h * sq * s of them) at the maximum SM clock: the floor of a
    forward whose products are too shallow (hd 32) to be its limit."""
    rate = EX2_PER_CLOCK_PER_SM * CARD["sms"] * CARD["max_sm_mhz"] * 1e6
    return b * h * sq * s / rate * 1e3


def _sdpa_inputs(q, k, v, mask, h=H):
    """[B, h, S, hd] copies of q, k, v and a boolean attn_mask [B, 1, 1, S]
    (True = take part) in which every row keeps at least one real key:
    SDPA's inputs for the library yardstick, made outside any timed region.
    """
    import torch

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], h, -1).transpose(1, 2) \
            .contiguous()

    keep = ~mask
    keep[~keep.any(dim=1), 0] = True
    return heads(q), heads(k), heads(v), keep[:, None, None, :].contiguous()


def sdpa_backend(q, k, v, attn_mask, dropout_p):
    """The name of the backend that scaled_dot_product_attention's dispatch
    picks for these inputs."""
    import torch
    from torch.nn.attention import SDPBackend

    names = {int(getattr(SDPBackend, n)): n for n in dir(SDPBackend)
             if n.isupper()}
    choice = int(torch._fused_sdp_choice(q, k, v, attn_mask, dropout_p,
                                         False))
    return names.get(choice, str(choice))


# Phase 15(c)'s tensor-parallel ranks: each of a model group of 2 runs the
# joint attention on its 4 of the 8 heads, [6, S, 256 / 2].
TP = 2


def attention_shapes():
    """(name, B, Sq, S, D, heads) of the kernel's calls. The serving path's
    canvas is 800x1344 (batcher.default_buckets: the short side 800 is
    already a multiple of 32), so its joint sequence is 25*42 image + 64
    text = 1114 tokens; 832x1344, the top training canvas, gives 26*42 + 64
    = 1156. A tensor-parallel rank's calls hold its heads: [6, S, D / TP]
    with H / TP heads."""
    from toist_tpu_torch.config import Config
    from toist_tpu_torch.data.batcher import default_buckets

    data = Config().data
    h, w = default_buckets(data.max_size, data.val_size)[0]
    s_eval = (h // 32) * (w // 32) + data.max_text_len
    s_832 = (832 // 32) * (1344 // 32) + data.max_text_len
    return [("encoder", B, s_eval, s_eval, D, H),
            ("decoder_cross", B, NUM_QUERIES, s_eval, D, H),
            ("encoder_832x1344", B, s_832, s_832, D, H),
            ("decoder_cross_832x1344", B, NUM_QUERIES, s_832, D, H),
            ("tp_encoder_832x1344", TRAIN_B, s_832, s_832, D // TP, H // TP),
            ("tp_decoder_cross_832x1344", TRAIN_B, NUM_QUERIES, s_832,
             D // TP, H // TP)]


def phase_kernel_vs_plain():
    import torch

    from toist_tpu_torch.ops.flash_attention import (attention_plain,
                                                     flash_attention)

    fa = flash_attention
    g = torch.Generator().manual_seed(SEED)
    cases = []
    for shape_name, b, Sq, S, d, h in attention_shapes():
        q32 = torch.randn((b, Sq, d), generator=g)
        k32 = torch.randn((b, S, d), generator=g)
        v32 = torch.randn((b, S, d), generator=g)
        mask = torch.rand(b, S, generator=g) < 0.2
        mask[b - 1] = True                      # one fully masked row
        mask = mask.cuda()
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v = (t.to("cuda", dt) for t in (q32, k32, v32))
            atol, rtol = TOL[dt_name]
            for m_name, m in (("mask", mask), ("no_mask", None)):
                before = (fa.launches, fa.fwd_tc_launches)
                o, lse = flash_attention(q, k, v, m, h)
                torch.cuda.synchronize()
                # bf16 runs the tensor-core kernel, f32 the scalar one.
                route = {"fwd": fa.launches - before[0],
                         "fwd_tc": fa.fwd_tc_launches - before[1]}
                ro, rlse = attention_plain(q, k, v, m, h)
                err = (o.float() - ro.float()).abs().max().item()
                # The scale-aware check, against the plain version in f32.
                rel = _rel_err(o, attention_plain(q.float(), k.float(),
                                                  v.float(), m, h)[0])
                # Fully masked rows have lse near -1.44e9, so relative.
                lse_err = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)
                           ).max().item()
                ok = (torch.isfinite(o).all().item() and torch.allclose(
                    o.float(), ro.float(), atol=atol, rtol=rtol)
                    and rel <= REL_TOL[dt_name]
                    and lse_err < 1e-5 and route == {
                        "fwd": 1, "fwd_tc": int(dt == torch.bfloat16)})
                case = {"shape": shape_name, "q": [b, Sq, d], "kv": [b, S, d],
                        "heads": h,
                        "dtype": dt_name, "mask": m_name, "route": route,
                        "max_abs_err": err, "rel_err": rel,
                        "lse_max_rel_err": lse_err, "atol": atol,
                        "rtol": rtol, "rel_tol": REL_TOL[dt_name]}
                log(f"[kernel] {json.dumps(case)}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with plain: "
                                         f"{case}")
                cases.append(case)
    return cases


def _requests(rng, spec, predictor, cfg):
    """Three collated batches: 8 landscape, 4 landscape (half empty) and 8
    portrait images, with mixed task ids."""
    from toist_tpu_torch.data.batcher import collate

    bs = cfg.optim.valid_batch_size
    batches = []
    for n, orient in ((bs, "landscape"), (bs // 2, "landscape"),
                      (bs, "portrait")):
        samples = []
        for i in range(n):
            long_ = int(rng.integers(900, 1334))   # short side resized to 800
            h, w = (800, long_) if orient == "landscape" else (long_, 800)
            img = rng.integers(0, 256, (h, w, 3), dtype="uint8")
            samples.append(predictor.prepare(img, int(1 + (i * 5) % 14)))
        bi = predictor.bucket(samples[0])
        batches.append(collate(samples, spec, bi, batch_size=bs))
    return batches


def _check_results(results, n_valid, num_queries):
    import numpy as np

    if len(results) != n_valid:
        raise AssertionError(f"{len(results)} results for {n_valid} images")
    for r in results:
        sc, bx = r["scores"], r["boxes"]
        if sc.shape != (num_queries,) or bx.shape != (num_queries, 4):
            raise AssertionError(f"bad shapes {sc.shape} {bx.shape}")
        if not (np.isfinite(bx).all() and (sc >= 0).all()
                and (sc <= 1).all()):
            raise AssertionError("scores outside [0, 1] or boxes not finite")
        if (np.diff(sc) > 0).any():
            raise AssertionError("scores not sorted")


def seeded_weights(seed):
    """Random flagship weights from ``seed`` in the reference checkpoint's
    layout, as torch tensors on the host."""
    import torch

    from toist_tpu_torch.config import Config
    from toist_tpu_torch.utils.convert import synth_reference_state_dict

    m = Config.from_sources(None, {}).model
    sd = synth_reference_state_dict(
        stage_sizes=(3, 4, 23, 3), enc=m.enc_layers, dec=m.dec_layers,
        d=m.hidden_dim, dim_feedforward=m.dim_feedforward,
        text_layers=m.text_layers, text_hidden=m.text_hidden,
        text_intermediate=m.text_intermediate, num_queries=m.num_queries,
        contrastive_hdim=m.contrastive_hdim, with_masks=False, seed=seed)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def phase_slice(smi, has_pil):
    import numpy as np
    import torch

    from toist_tpu_torch.config import Config
    from toist_tpu_torch.ops.flash_attention import flash_attention
    from toist_tpu_torch.predict import Predictor

    cfg = Config.from_sources(None, {"run": {"compute_eval_losses": False}})
    m = cfg.model
    t0 = time.perf_counter()
    state_dict = seeded_weights(SEED)
    predictor = Predictor.from_state_dict(state_dict, cfg)
    n_params = sum(p.numel() for p in predictor.model.parameters())
    log(f"[slice] weights from seed {SEED}: {n_params} parameters, "
        f"{predictor.model.compute_dtype}, set-up "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    batches = _requests(rng, predictor.spec, predictor, cfg)
    for b in batches:                       # warm-up: one pass per canvas
        predictor.predict_batch(b)
    torch.cuda.synchronize()

    # The counted run: every request below goes through the main path.
    reset_counts()
    lat = []
    for rep in range(3):
        for b in batches:
            before = read_counts()
            t = time.perf_counter()
            res = predictor.predict_batch(b)   # ends in a device->host copy
            dt = time.perf_counter() - t
            n_valid = int(b["sample_valid"].sum())
            _check_results(res, n_valid, m.num_queries)
            after = read_counts()
            got = {k: after[k] - before[k] for k in ("fwd", "fwd_tc")}
            if got != {"fwd": LAUNCHES_PER_FORWARD,
                       "fwd_tc": LAUNCHES_PER_FORWARD}:
                raise AssertionError(f"kernel launches in one bf16 forward: "
                                     f"{got}")
            lat.append((b["images"].shape[1:3], n_valid, dt))
    if has_pil:
        from PIL import Image

        imgs = [Image.fromarray(rng.integers(0, 256, (480, 640, 3),
                                             dtype="uint8")),
                Image.fromarray(rng.integers(0, 256, (700, 500, 3),
                                             dtype="uint8"))]
        before = flash_attention.fwd_tc_launches
        dets = predictor(imgs, task_ids=[3, 11])
        _check_results(dets, 2, m.num_queries)
        if (flash_attention.fwd_tc_launches - before
                != 2 * LAUNCHES_PER_FORWARD):
            raise AssertionError("Predictor.__call__ did not run the kernel "
                                 "in both of its forwards")
        log(f"[slice] Predictor.__call__ on 2 PIL images: ok")
    launches = read_counts()

    for hw in sorted({tuple(x[0]) for x in lat}):
        for nv in sorted({x[1] for x in lat if tuple(x[0]) == hw}):
            ts = [x[2] for x in lat if tuple(x[0]) == hw and x[1] == nv]
            ms = sorted(t * 1e3 for t in ts)
            log(f"[slice] canvas {hw[0]}x{hw[1]} batch "
                f"{cfg.optim.valid_batch_size} ({nv} images): latency ms "
                f"{ms} -> {nv / (sum(ts) / len(ts)):.2f} img/s | {smi}")
    full = [x for x in lat if x[1] == cfg.optim.valid_batch_size]
    img_s = sum(x[1] for x in full) / sum(x[2] for x in full)
    log(f"[slice] full batches of {cfg.optim.valid_batch_size}: "
        f"{img_s:.2f} img/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")
    return state_dict, batches[0], launches


def phase_slice_kernel_vs_plain(state_dict, batch):
    import torch

    from toist_tpu_torch.config import Config
    from toist_tpu_torch.models.layers import set_fused_attention
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.train.step import eval_forward

    cfg = Config.from_sources(None, {"model": {"compute_dtype": "float32"}})
    model = TOIST.from_state_dict(state_dict, cfg.model, device="cuda")
    out_k, _ = eval_forward(model, batch)
    set_fused_attention(model, False)
    out_p, _ = eval_forward(model, batch)
    errs = {}
    for key in ("pred_logits", "pred_boxes"):
        a, b = out_k[key], out_p[key]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{key} not finite")
        errs[key] = (a - b).abs().max().item()
    log(f"[slice-f32] kernel vs plain max abs err {json.dumps(errs)} "
        f"(tolerance {SLICE_TOL})")
    if max(errs.values()) > SLICE_TOL:
        raise AssertionError(f"slice kernel vs plain: {errs}")
    return errs


COUNTERS = {"fwd": "launches", "dkv": "dkv_launches", "dq": "dq_launches",
            "fwd_tc": "fwd_tc_launches", "dkv_tc": "dkv_tc_launches",
            "dq_tc": "dq_tc_launches", "dropout": "dropout_launches"}


def reset_counts():
    from toist_tpu_torch.ops.flash_attention import flash_attention
    from toist_tpu_torch.ops.lsa import solve_lsa_batch

    for name in COUNTERS.values():
        setattr(flash_attention, name, 0)
    solve_lsa_batch.launches = 0


def read_counts():
    from toist_tpu_torch.ops.flash_attention import flash_attention
    from toist_tpu_torch.ops.lsa import solve_lsa_batch

    counts = {k: getattr(flash_attention, n) for k, n in COUNTERS.items()}
    counts["lsa"] = solve_lsa_batch.launches
    return counts


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.abs().max().item()
    if scale == 0.0:
        return 0.0 if err == 0.0 else math.inf
    return err / scale


def phase_attention_backward():
    """Kernels 1b, 2, 3 against autograd through the plain version."""
    import torch

    from toist_tpu_torch.ops import flash_attention as fa

    s_832 = (832 // 32) * (1344 // 32) + 64
    s_480 = (480 // 32) * (800 // 32) + 64
    shapes = [("encoder_832x1344", s_832, s_832),
              ("decoder_cross_832x1344", NUM_QUERIES, s_832),
              ("encoder_480x800", s_480, s_480)]
    g = torch.Generator().manual_seed(SEED + 1)
    cases = []
    for shape_name, Sq, S in shapes:
        q32, k32, v32, w32 = (torch.randn((TRAIN_B, n, D), generator=g)
                              for n in (Sq, S, S, Sq))
        mask = torch.rand(TRAIN_B, S, generator=g) < 0.2
        mask[TRAIN_B - 1] = True                 # one fully masked row
        mask = mask.cuda()
        mask_u8 = mask.view(torch.uint8)
        w = w32.cuda()
        seed = torch.tensor([SEED + 7], dtype=torch.int64, device="cuda")
        # The kernels' bit function against its numpy version.
        keep = fa.dropout_keep_mask(seed, TRAIN_B, H, Sq, S, DROP_RATE)
        bits_equal = torch.equal(keep.cpu(), fa.dropout_keep_mask_plain(
            SEED + 7, TRAIN_B, H, Sq, S, DROP_RATE))
        log(f"[attn-bwd] {shape_name}: kernel dropout mask equals "
            f"dropout_keep_mask_plain bit for bit: {bits_equal}")
        if not bits_equal:
            raise AssertionError(f"dropout mask differs from the plain bit "
                                 f"function at {shape_name}")
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v = (t.to("cuda", dt) for t in (q32, k32, v32))
            for rate in (0.0, DROP_RATE):
                dq_ = fa.drop_threshold(rate)
                sd = seed if dq_ else None
                kp = keep if dq_ else None

                def kernel(a, b, c):
                    return fa.FlashAttention.apply(a, b, c, mask_u8, H, dq_,
                                                   sd)[0]

                def plain(a, b, c):
                    return fa.attention_plain(a.float(), b.float(),
                                              c.float(), mask, H, kp,
                                              rate)[0]

                before = read_counts()
                got = _fwd_bwd(kernel, q, k, v, w)
                after = read_counts()
                again = _fwd_bwd(kernel, q, k, v, w)
                torch.cuda.synchronize()
                # bf16 runs the tensor-core route, f32 the scalar one.
                tc = int(dt == torch.bfloat16)
                route = {n: after[n] - before[n] for n in
                         ("fwd", "dkv", "dq", "fwd_tc", "dkv_tc", "dq_tc")}
                want = _fwd_bwd(plain, q, k, v, w)
                errs = {n: _rel_err(a, b) for n, a, b in
                        zip(("o", "dq", "dk", "dv"), got, want)}
                case = {"shape": shape_name, "q": [TRAIN_B, Sq, D],
                        "kv": [TRAIN_B, S, D], "dtype": dt_name,
                        "rate": rate, "route_launches": route,
                        "rel_err": errs,
                        "tol": REL_TOL[dt_name],
                        "max_abs_err": max((a.float() - b.float()).abs()
                                           .max().item() for a, b in
                                           zip(got, want))}
                ok = (route == {"fwd": 1, "dkv": 1, "dq": 1, "fwd_tc": tc,
                                "dkv_tc": tc, "dq_tc": tc}
                      and max(errs.values()) <= REL_TOL[dt_name]
                      and all(torch.isfinite(t).all().item() for t in got)
                      and (got[1][TRAIN_B - 1] == 0).all().item()
                      and (got[2][TRAIN_B - 1] == 0).all().item()
                      and all(torch.equal(a, b) for a, b in zip(got, again)))
                if dq_:
                    share = keep.float().mean().item()
                    case["kept_share"] = share
                    ok = ok and abs(share - (1 - dq_ / 256)) < 1e-3
                log(f"[attn-bwd] {json.dumps(case)}")
                if not ok:
                    raise AssertionError(f"attention kernels disagree with "
                                         f"plain: {case}")
                cases.append(case)
    return cases


def _fwd_bwd(fn, q, k, v, w):
    import torch

    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(q, k, v)
    grads = torch.autograd.grad((o.float() * w).sum(), (q, k, v))
    return (o.detach(),) + grads


def lsa_case(name, cost, n, scipy_check, timed=None):
    """One LSA case: the kernel against the plain version (equal
    assignments) and scipy (scipy_check "assignment": equal assignments;
    "total": equal total cost, rtol 1e-6 and atol 1e-5; None: not checked).
    For a case that phase 10 times (its inputs go into ``timed``), also the
    bytes bound, the plain solver's host-clock ms and the dependent steps of
    the longest problem."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment

    from toist_tpu_torch.ops.lsa import (lsa_scan_steps, solve_lsa_batch,
                                         solve_lsa_batch_plain)

    c_cpu, n_cpu = torch.from_numpy(cost), torch.from_numpy(n)
    c_gpu, n_gpu = c_cpu.cuda(), n_cpu.cuda()
    got = solve_lsa_batch(c_gpu, n_gpu).cpu().numpy()
    want = solve_lsa_batch_plain(c_cpu, n_cpu).numpy()
    mismatches = int((got != want).any(axis=1).sum())
    scipy_bad = 0
    for b in range(cost.shape[0]):
        rows, cols = linear_sum_assignment(
            np.where(np.isfinite(cost[b, :n[b]]), cost[b, :n[b]], 1e30))
        if scipy_check == "total":
            ours = cost[b, np.arange(n[b]), got[b, :n[b]]].sum()
            scipy_bad += not np.isclose(ours, cost[b, rows, cols].sum(),
                                        rtol=1e-6, atol=1e-5)
        elif scipy_check == "assignment":
            scipy_bad += not np.array_equal(got[b, :n[b]], cols)
        scipy_bad += not (got[b, n[b]:] == -1).all()
    case = {"case": name, "shape": list(cost.shape),
            "n_rows": [int(n.min()), int(n.max())],
            "problems_differing_from_plain": mismatches,
            "scipy_check": scipy_check,
            "problems_differing_from_scipy": int(scipy_bad)}
    if timed is not None:
        timed[name] = (c_gpu, n_gpu)       # device ms in phase 10
        # Bytes bound: the costs and counts read once, the assignment
        # written once.
        case["bound_ms"] = (c_gpu.nbytes + n_gpu.nbytes + got.nbytes) \
            / PEAK_BYTES_S * 1e3
        # The plain solver runs on the host: host-clock ms, copies
        # included.
        t0 = time.perf_counter()
        for _ in range(5):
            solve_lsa_batch_plain(c_gpu, n_gpu)
        case["plain_ms"] = (time.perf_counter() - t0) / 5 * 1e3
        # Problems run concurrently: the longest chain sets the time.
        case["steps_longest"] = int(lsa_scan_steps(c_cpu, n_cpu).max())
    log(f"[lsa] {json.dumps(case)}")
    if mismatches or scipy_bad:
        raise AssertionError(f"LSA kernel disagrees: {case}")
    return case


def phase_lsa():
    """Kernel 4 against the plain version and scipy."""
    import numpy as np

    from toist_tpu_torch.ops.lsa import softkd_like_costs

    rng = np.random.default_rng(SEED)
    L_B, T = 6 * TRAIN_B, 25
    cont = rng.normal(size=(L_B, T, NUM_QUERIES)).astype(np.float32)
    ties = np.round(rng.uniform(size=cont.shape) * 3).astype(np.float32)
    bad = cont.copy()
    bad[0, 3] = np.nan
    bad[1] = np.inf
    n_pad = rng.integers(0, T + 1, L_B).astype(np.int32)
    full = np.full(L_B, T, np.int32)
    big = rng.normal(size=(L_B, 100, 100)).astype(np.float32)
    n_big = rng.integers(60, 101, L_B).astype(np.int32)
    timed = {}
    cases = [lsa_case("continuous", cont, full, "assignment", timed),
             lsa_case("padded", cont, n_pad, "assignment"),
             lsa_case("ties", ties, n_pad, "total"),
             lsa_case("non_finite", bad, full, None),
             lsa_case("100x100", big, n_big, "assignment", timed),
             lsa_case("softkd", *softkd_like_costs(SEED, L_B, NUM_QUERIES),
                      "total", timed)]
    return cases, timed


def _fixture_config(root):
    from toist_tpu_torch.config import Config
    from toist_tpu_torch.data.fixtures import generate_fixture

    generate_fixture(root, num_tasks=2, imgs_per_split=30, seed=SEED)
    return Config.from_sources(None, {"data": {
        "coco_path": root, "refexp_ann_path": os.path.join(root,
                                                           "annotations"),
        "tasks": [1, 2], "num_workers": 4}})


def phase_train(smi, state_dict, root):
    """The training slice at full width through train_one_epoch."""
    import torch

    from toist_tpu_torch.data.batcher import BatchIterator, BucketSpec, \
        train_buckets
    from toist_tpu_torch.data.cocotasks import build_task_dataset
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.train.criterion import build_weight_dict
    from toist_tpu_torch.train.engine import train_one_epoch
    from toist_tpu_torch.train.state import init_train_state
    from toist_tpu_torch.train.step import make_train_step

    cfg = _fixture_config(root)
    m, d = cfg.model, cfg.data
    tokenizer = build_tokenizer(cfg)
    datasets = [build_task_dataset(d, t, "train", tokenizer)
                for t in d.tasks]
    spec = BucketSpec(buckets=train_buckets(d.max_size, d.train_scales),
                      max_text_len=d.max_text_len, max_boxes=d.max_boxes,
                      num_logit_cols=d.num_logit_cols)
    it = BatchIterator(datasets, spec, batch_size=TRAIN_B, seed=cfg.run.seed,
                       num_workers=d.num_workers)
    model = TOIST.from_state_dict(state_dict, m, device="cuda")
    state = init_train_state(model, cfg, steps_per_epoch=len(it),
                             total_steps=len(it) * cfg.optim.epochs)
    step = make_train_step(cfg, build_weight_dict(cfg.loss, False,
                                                  m.dec_layers))
    log(f"[train] {len(datasets[0]) + len(datasets[1])} fixture images, "
        f"{len(it)} batches of {TRAIN_B}, dropout {m.dropout}/"
        f"{m.resizer_dropout}, {m.compute_dtype} with f32 masters")

    state, sc = step(state, next(it.epoch(1, num_workers=1)))  # warm-up
    if not bool(sc["loss_is_finite"]):
        raise AssertionError("warm-up loss not finite")
    torch.cuda.synchronize()
    masters0 = [mm.detach().clone() for _, mm in state.masters]
    frozen = [(n, p.detach().clone()) for n, p in model.named_parameters()
              if not p.requires_grad]
    ema0 = [e.clone() for e in state.ema.values()]
    torch.cuda.reset_peak_memory_stats()
    steps = []

    def counted(state, batch):
        before = read_counts()
        t0 = time.perf_counter()
        state, scalars = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = read_counts()
        steps.append({
            "canvas": list(batch["images"].shape[1:3]),
            "images": int(batch["sample_valid"].sum()), "ms": dt * 1e3,
            "launches": {k: after[k] - before[k] for k in after},
            "scalars": {k: float(v) for k, v in scalars.items()}})
        return state, scalars

    reset_counts()
    state, summary = train_one_epoch(counted, state, it, epoch=0,
                                     print_freq=1)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for st in steps:
        log(f"[train] step {json.dumps(st)}")
    canvases = {tuple(st["canvas"]) for st in steps}
    # bf16 training: every attention launch takes the tensor-core route.
    want = {"fwd": LAUNCHES_PER_FORWARD, "dkv": LAUNCHES_PER_FORWARD,
            "dq": LAUNCHES_PER_FORWARD, "fwd_tc": LAUNCHES_PER_FORWARD,
            "dkv_tc": LAUNCHES_PER_FORWARD, "dq_tc": LAUNCHES_PER_FORWARD,
            "dropout": 3 * LAUNCHES_PER_FORWARD, "lsa": 1}
    bad = [st for st in steps if st["launches"] != want
           or not all(math.isfinite(v) for v in st["scalars"].values())]
    if len(steps) < 5 or len(canvases) < 2 or bad:
        raise AssertionError(f"training run: {len(steps)} steps on "
                             f"{len(canvases)} canvases, bad steps {bad}")
    changed = sum(not torch.equal(a, mm) for a, (_, mm) in
                  zip(masters0, state.masters))
    frozen_moved = [n for n, p in frozen
                    if not torch.equal(p, dict(model.named_parameters())[n])]
    ema_moved = sum(not torch.equal(a, e) for a, e in
                    zip(ema0, state.ema.values()))
    n_train = len(state.masters)
    log(f"[train] parameters: {changed}/{n_train} trainable changed, "
        f"{len(frozen) - len(frozen_moved)}/{len(frozen)} frozen unchanged, "
        f"EMA moved on {ema_moved}/{n_train}")
    if changed != n_train or frozen_moved or ema_moved != n_train:
        raise AssertionError(f"update check failed: frozen moved "
                             f"{frozen_moved[:5]}")
    for hw in sorted(canvases):
        sel = [st for st in steps if tuple(st["canvas"]) == hw]
        ms = sorted(round(st["ms"], 2) for st in sel)
        n_img = sum(st["images"] for st in sel)
        log(f"[train] canvas {hw[0]}x{hw[1]}: step ms {ms} -> "
            f"{n_img / sum(st['ms'] for st in sel) * 1e3:.2f} img/s | {smi}")
    total_img = sum(st["images"] for st in steps)
    total_s = sum(st["ms"] for st in steps) / 1e3
    log(f"[train] {len(steps)} steps, {total_img} images in {total_s:.3f} s:"
        f" {total_img / total_s:.2f} img/s, peak memory {peak:.2f} GiB, "
        f"launches {json.dumps(launches)}, epoch summary "
        f"{json.dumps(summary)} | {smi}")
    first_batch = next(it.epoch(0, num_workers=1))
    top = max(canvases, key=lambda hw: hw[0] * hw[1])
    profile = _profile_steps(smi, step, state, it, top)
    return {"steps": steps, "launches": launches, "peak_gib": peak,
            "img_s": total_img / total_s, "profile": profile}, first_batch


def _canvas(batch):
    """(H, W) of a batch, or of a distillation pair's."""
    return tuple((batch["sth"] if "sth" in batch else batch)["images"]
                 .shape[1:3])


def _profile_steps(smi, step, state, it, canvas, n=3, label="bf16",
                   ranges=()):
    """torch.profiler over n training steps on one canvas after a warm-up
    step there: device kernel ms per step by kind and by attention kernel,
    against the host-clock ms of n unprofiled steps (busy share); for each
    record_function range named in ``ranges``, its device span ms per step
    (the profiler's GPU annotation of the range)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from toist_tpu_torch.utils.profiling import kernel_kind

    batches = [b for b in it.epoch(2, num_workers=1)
               if _canvas(b) == canvas]
    while len(batches) < n + 1:
        batches += batches
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    wall = []
    for b in batches[1:n + 1]:
        t0 = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[1:n + 1]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
    kinds, by_name, launches, top = {}, {}, 0, []
    spans = {r: "not measured" for r in ranges}
    for e in prof.key_averages():
        if e.key in spans and e.device_type == DeviceType.CUDA:
            spans[e.key] = e.device_time_total / 1e3 / n
        # Device events only; a user annotation (the optimizer's
        # "Optimizer.step#..." range) spans kernels counted on their own.
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms = us / 1e3 / n
        kind = kernel_kind(e.key)
        kinds[kind] = kinds.get(kind, 0.0) + ms
        launches += e.count
        top.append((ms, e.key[:70], kind, e.count / n))
        if kind.startswith("attention") or kind == "LSA":
            by_name[e.key[:60]] = {"ms_per_step": ms, "calls_per_step":
                                   e.count / n}
    kernel_ms = sum(kinds.values())
    res = {"canvas": list(canvas), "steps": n, "wall_ms": wall,
           "kernel_ms_per_step": kernel_ms,
           "busy_share": [kernel_ms / w for w in wall],
           "kernel_launches_per_step": launches / n,
           "ms_per_step_by_kind": dict(sorted(kinds.items(),
                                              key=lambda kv: -kv[1])),
           "attention_and_lsa": by_name,
           "top_kernels": [{"ms_per_step": ms, "name": name, "kind": kind,
                            "calls_per_step": calls}
                           for ms, name, kind, calls in sorted(top)[::-1][:12]]}
    if ranges:
        res["range_device_ms_per_step"] = spans
    if kernel_ms <= 0:      # the profiler saw no device time: not measured
        res = {"canvas": list(canvas), "wall_ms": wall,
               "kernel_ms_per_step": "not measured"}
    log(f"[profile] {label} training step {json.dumps(res)} | {smi}")
    return res


def phase_train_kernel_vs_plain(state_dict, batch):
    """One f32 training step's matching, losses and gradients with the
    kernels and without them. Also returns the LSA problem of that step's
    matching (cost [L*B, T, Q], n_rows [L*B])."""
    import torch

    from toist_tpu_torch.config import Config
    from toist_tpu_torch.models.layers import set_fused_attention
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.ops.matching import assignment_problem, \
        hungarian_match_levels, match_costs
    from toist_tpu_torch.train import criterion as crit
    from toist_tpu_torch.train.optim import freeze_parameters, label_params
    from toist_tpu_torch.train.step import TRAIN_KEYS, batch_to_device

    cfg = Config.from_sources(None, {"model": {
        "compute_dtype": "float32", "dropout": 0.0, "resizer_dropout": 0.0}})
    lc = cfg.loss
    wd = crit.build_weight_dict(lc, False, cfg.model.dec_layers)
    model = TOIST.from_state_dict(state_dict, cfg.model, device="cuda")
    freeze_parameters(model, label_params(model))
    model.train()
    x = batch_to_device(batch, "cuda", TRAIN_KEYS)
    x_cpu = {k: v.cpu() for k, v in x.items()}
    args = [x[k] for k in ("images", "image_mask", "text_ids", "text_mask")]
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    bv = x["box_valid"] & x["sample_valid"][:, None]

    def levels(out):
        return (torch.cat([out["aux_pred_logits"], out["pred_logits"][None]]),
                torch.cat([out["aux_pred_boxes"], out["pred_boxes"][None]]))

    def match(out, dev):
        lg, bx = levels({k: v.detach().to(dev) for k, v in out.items()})
        return hungarian_match_levels(lg, bx, x["boxes"].to(dev),
                                      x["positive_map"].to(dev),
                                      bv.to(dev), lc.set_cost_class,
                                      lc.set_cost_bbox, lc.set_cost_giou)

    def step(out, tgt, matching=None):
        losses = crit.set_criterion(out, tgt, lc, matching)
        total = crit.total_loss(losses, wd)
        total.backward()
        grads = {n: p.grad.detach().clone() for n, p in params
                 if p.grad is not None}
        model.zero_grad(set_to_none=True)
        values = {k: float(v.detach()) for k, v in losses.items()
                  if not k.startswith("_")}
        values["loss"] = float(total.detach())
        return values, grads

    # With the kernels: attention kernels and the LSA kernel on the card.
    reset_counts()
    out_k, _ = model(*args)
    t2q_k = match(out_k, "cuda")
    lk, gk = step(out_k, x, t2q_k)
    torch.cuda.synchronize()
    with_kernels = read_counts()
    # The same costs through the plain solver: assignments must be equal.
    solver_equal = torch.equal(t2q_k.cpu(), match(out_k, "cpu"))
    # Without: plain attention, the criterion and its plain LSA on the CPU.
    set_fused_attention(model, False)
    reset_counts()
    out_p, _ = model(*args)
    out_p = {k: v.cpu() for k, v in out_p.items()}
    t2q_p = match(out_p, "cpu")
    # Problems whose two runs matched differently must be near-ties: both
    # assignments cost the same within 1e-4 on the kernel run's costs.
    lg, bxs = levels({k: v.detach() for k, v in out_k.items()})
    L = lg.shape[0]
    cost = match_costs(lg.flatten(0, 1), bxs.flatten(0, 1),
                       x["boxes"].repeat(L, 1, 1),
                       x["positive_map"].repeat(L, 1, 1),
                       lc.set_cost_class, lc.set_cost_bbox,
                       lc.set_cost_giou).cpu()
    a_k, a_p = t2q_k.cpu().flatten(0, 1), t2q_p.flatten(0, 1)
    differ = (a_k != a_p).any(-1).nonzero().flatten().tolist()
    gaps = []
    for i in differ:
        v = a_k[i] >= 0
        ck = cost[i, a_k[i][v].long(), v.nonzero().flatten()].sum().item()
        cp = cost[i, a_p[i][v].long(), v.nonzero().flatten()].sum().item()
        gaps.append(abs(ck - cp) / max(1.0, abs(ck)))
    with torch.no_grad():
        own = float(crit.total_loss(crit.set_criterion(out_p, x_cpu, lc), wd))
    lp, gp = step(out_p, x_cpu, t2q_k.cpu())
    without = read_counts()
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-6) for k in lk)
    # Two gradients are 0 by construction, so both runs compute rounding
    # noise there: a separate key bias (RoBERTa's) adds one constant to a
    # whole softmax row, and the first decoder layer's self-attention sees
    # tgt = 0, so every value is b_v and its output is b_v whatever the
    # weights. They are held to 1e-4 of the gradient of their module's other
    # parameter (weight <-> bias) in both runs instead of to their own.
    first_sa = "transformer.decoder.layers.0.self_attn.in_proj_weight"
    zero_grad = [n for n in gp if n.endswith(".key.bias") or n == first_sa]
    partner = {n: (n[:-len("weight")] + "bias" if n.endswith("weight")
                   else n[:-len("bias")] + "weight") for n in zero_grad}
    noise = max((max(g[n].abs().max().item() for g in (gk, gp))
                 / gp[partner[n]].abs().max().item()
                 for n in zero_grad), default=0.0)
    grad_errs = sorted(((gk[n] - gp[n].to(gk[n].device)).abs().max().item()
                        / max(gp[n].abs().max().item(), 1e-12), n)
                       for n in gp if n not in zero_grad)
    grad_err = grad_errs[-1][0]
    res = {"solver_equal_on_same_costs": solver_equal,
           "problems": int(a_k.shape[0]),
           "problems_matched_differently_across_runs": len(differ),
           "their_max_rel_cost_gap": max(gaps, default=0.0),
           "total_loss": {"kernels": lk["loss"], "plain": lp["loss"],
                          "plain_own_matching": own},
           "loss_max_rel_err": loss_err, "grad_max_rel_err": grad_err,
           "worst_grads": grad_errs[-3:], "grads_compared": len(grad_errs),
           "zero_by_construction": len(zero_grad),
           "their_grad_over_partner_grad": noise,
           "launches_with": with_kernels, "launches_without": without}
    log(f"[train-f32] kernels vs plain {json.dumps(res)} (tolerances: "
        f"losses {LOSS_RTOL}, gradients {STEP_GRAD_TOL}, zero by "
        f"construction 1e-4, cost gap 1e-4)")
    # f32: the scalar forward and backward route, no dropout.
    want = {"fwd": LAUNCHES_PER_FORWARD, "dkv": LAUNCHES_PER_FORWARD,
            "dq": LAUNCHES_PER_FORWARD, "fwd_tc": 0, "dkv_tc": 0,
            "dq_tc": 0, "dropout": 0, "lsa": 1}
    if (not solver_equal or max(gaps, default=0.0) > 1e-4
            or loss_err > LOSS_RTOL or grad_err > STEP_GRAD_TOL
            or noise > 1e-4
            or set(gk) != set(gp) or with_kernels != want
            or any(without.values())):
        raise AssertionError(f"training step kernels vs plain: {res}")
    cost_t, n_valid, _ = assignment_problem(cost, bv.repeat(L, 1).cpu())
    return res, (cost_t.numpy(), n_valid.numpy())


def _attention_times(q, k, v, mask, w, rate, backward, h=H):
    """Device ms per call of the attention kernels at ``rate``, of the plain
    version given the kernels' dropout mask (its forward; autograd's dQ +
    dK + dV), and of PyTorch's scaled_dot_product_attention at the same
    rate (the library yardstick, never called by the port): its forward,
    forward + backward, and backward alone (autograd over a retained
    graph)."""
    import torch
    import torch.nn.functional as F

    from toist_tpu_torch.ops import flash_attention as fa

    b, sq, s = q.shape[0], q.shape[1], k.shape[1]
    mask_u8 = mask.view(torch.uint8)
    drop_q = fa.drop_threshold(rate)
    seed = keep = None
    if drop_q:
        seed = torch.tensor([SEED + 7], dtype=torch.int64, device="cuda")
        keep = fa.dropout_keep_mask(seed, b, h, sq, s, rate)
    sq_, sk_, sv_, sm_ = _sdpa_inputs(q, k, v, mask, h)

    def sdpa():
        return F.scaled_dot_product_attention(sq_, sk_, sv_, sm_,
                                              dropout_p=rate)

    t = {"fwd": device_ms(lambda: fa._launch_fwd(q, k, v, mask_u8, h,
                                                  drop_q, seed)),
         "plain_fwd": device_ms(lambda: fa.attention_plain(
             q, k, v, mask, h, keep, rate))}
    with torch.no_grad():
        t["library_fwd"] = device_ms(sdpa)
    t["sdpa_backend"] = sdpa_backend(sq_, sk_, sv_, sm_, rate)
    if not backward:
        return t
    o, lse = fa._launch_fwd(q, k, v, mask_u8, h, drop_q, seed)
    do = w.to(q.dtype).contiguous()
    args = (q, k, v, mask_u8, do, lse, fa.row_dsum(do, o, h), h, drop_q,
            seed)
    t["dkv"] = device_ms(lambda: fa._launch_dkv(*args))
    t["dq"] = device_ms(lambda: fa._launch_dq(*args))
    qp, kp, vp = (x.detach().requires_grad_() for x in (q, k, v))
    op = fa.attention_plain(qp, kp, vp, mask, h, keep, rate)[0]
    t["plain_bwd"] = device_ms(lambda: torch.autograd.grad(
        op, (qp, kp, vp), do, retain_graph=True))
    sq_, sk_, sv_ = (x.requires_grad_() for x in (sq_, sk_, sv_))
    sdo = do.reshape(b, sq, h, -1).transpose(1, 2).contiguous()
    t["library_fwd_bwd"] = device_ms(lambda: torch.autograd.grad(
        sdpa(), (sq_, sk_, sv_), sdo))
    so = sdpa()
    t["library_bwd"] = device_ms(lambda: torch.autograd.grad(
        so, (sq_, sk_, sv_), sdo, retain_graph=True))
    return t


def phase_times(smi, lsa_cases, lsa_inputs):
    """Phase 10: device ms per call (device_ms) of every hand-written
    kernel, of its plain version and of the library call: the attention
    kernels at the serving shapes (forward) and the training shapes
    (forward, dK/dV, dQ at rate 0 and 0.1), in bf16 and, at the encoder
    shapes, in f32; the LSA kernel on phase 7's timed costs, with the
    steps of the longest problem and the ns per step."""
    import torch

    s_eval = attention_shapes()[0][2]
    s_832 = (832 // 32) * (1344 // 32) + 64
    g = torch.Generator().manual_seed(SEED + 2)
    out = {}
    for name, b, sq, s, backward, d, h in (
            ("serving_encoder", B, s_eval, s_eval, False, D, H),
            ("serving_decoder_cross", B, NUM_QUERIES, s_eval, False, D, H),
            ("train_encoder", TRAIN_B, s_832, s_832, True, D, H),
            ("train_decoder_cross", TRAIN_B, NUM_QUERIES, s_832, True, D, H),
            # A tensor-parallel rank's share (phase 15(c)): its 4 heads.
            ("tp_train_encoder", TRAIN_B, s_832, s_832, True, D // TP,
             H // TP),
            ("tp_train_decoder_cross", TRAIN_B, NUM_QUERIES, s_832, True,
             D // TP, H // TP)):
        q32, k32, v32, w = (torch.randn((b, n, d), generator=g)
                            for n in (sq, s, s, sq))
        mask = torch.rand(b, s, generator=g) < 0.2
        mask[b - 1] = True                      # one fully masked row
        mask, w = mask.cuda(), w.cuda()
        out[name] = {}
        for dt_name, dt in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            if dt == torch.float32 and ("encoder" not in name
                                         or name.startswith("tp_")):
                continue
            q, k, v = (x.to("cuda", dt) for x in (q32, k32, v32))
            rates = (0.0, DROP_RATE) if backward and dt == torch.bfloat16 \
                and not name.startswith("tp_") else (0.0,)
            per = {}
            for rate in rates:
                per[rate] = _attention_times(q, k, v, mask, w, rate,
                                             backward, h)
                per[rate]["bound"] = {
                    kind: attention_bound(kind, b, sq, s, dt_name, d, h)
                    for kind in (PRODUCTS if backward else ("fwd",))}
                per[rate]["exp_bound_ms"] = exp_bound(b, sq, s, h)
            log(f"[times] {name} [{b},{sq},{d}] over [{b},{s},{d}], {h} "
                f"heads, {dt_name}: {json.dumps(per)}")
            if DROP_RATE in per:
                per["dropout_overhead"] = {
                    kind: per[DROP_RATE][kind] / per[0.0][kind] - 1.0
                    for kind in PRODUCTS}
                log(f"[times] {name} {dt_name}: rate {DROP_RATE} adds "
                    f"{json.dumps(per['dropout_overhead'])} of each "
                    f"kernel's rate-0 time")
            out[name][dt_name] = per
    out["lsa"] = {case["case"]: lsa_time(smi, case, lsa_inputs)
                  for case in lsa_cases if case["case"] in lsa_inputs}
    return out


def lsa_time(smi, case, lsa_inputs):
    """device_ms of the LSA kernel on one timed case's costs, beside its
    bound, the plain version's host ms and the ns per dependent step."""
    from toist_tpu_torch.ops.lsa import solve_lsa_batch

    c, n = lsa_inputs[case["case"]]
    ms = device_ms(lambda: solve_lsa_batch(c, n))
    t = {"shape": case["shape"], "ms": ms, "bound_ms": case["bound_ms"],
         "bound_by": "bytes", "plain_ms": case["plain_ms"],
         "steps_longest": case["steps_longest"],
         "ns_per_step": ms * 1e6 / max(case["steps_longest"], 1)}
    log(f"[times] lsa {case['case']} {json.dumps(t)} | {smi}")
    return t


class _Hooks:
    """Wraps what toist_tpu_torch.main calls (its train and eval steps,
    engine.evaluate, checkpoint.restore) to count each call's kernel
    launches and keep what phases 11-13 check; ``undo`` puts them back.
    With ``distill`` (phase 12) it also wraps the distillation and cluster
    eval step makers, times each train step (host clock with a device
    sync), snapshots the state before the first step, keeps the bank's
    growth per step, runs the cluster bank's entry points under
    torch.cuda.set_sync_debug_mode("error") (a host sync there raises) and
    keeps their last inputs and the first softkd re-pairing problem. With
    ``seg`` (phase 13) it times each plain train step the same way, keeps
    its scalars, snapshots the state before the first step, wraps the
    cluster eval step maker and the bank's entry points as for ``distill``,
    and keeps the timings of each eval batch's mask postprocess
    (``finish_masks_device``) and the first eval batch's mask logits."""

    def __init__(self, distill=False, seg=False):
        import torch

        from toist_tpu_torch import main as pmain
        from toist_tpu_torch.train import checkpoint as ckpt
        from toist_tpu_torch.train import cluster as cl
        from toist_tpu_torch.train import criterion as crit
        from toist_tpu_torch.train import engine

        self.undo_list = []
        self.train, self.evals, self.restored, self.state = [], [], [], None
        self.first_dets = []
        self.steps, self.first, self.cluster_inputs = [], None, {}
        self.softkd_problem, self.cluster_calls = None, 0

        def patch(obj, name, wrap):
            self.undo_list.append((obj, name, getattr(obj, name)))
            setattr(obj, name, wrap(getattr(obj, name)))

        timed_steps = distill or seg

        def counted_train(make):
            def make_step(*args, **kwargs):
                step = make(*args, **kwargs)

                def train_step(state, batch):
                    if timed_steps and self.first is None:
                        self.first = _snapshot(state)
                    before = read_counts()
                    if distill:
                        bank0 = state.cluster_bank.update_count.sum().item()
                    if timed_steps:
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, scalars = step(state, batch)
                    if timed_steps:
                        torch.cuda.synchronize()
                        ms = (time.perf_counter() - t0) * 1e3
                    after = read_counts()
                    self.train.append({k: after[k] - before[k]
                                       for k in after})
                    self.state = state
                    if distill:
                        self.steps.append(_distill_step_record(
                            state, batch, scalars, ms, bank0))
                    elif seg:
                        self.steps.append({
                            "canvas": list(batch["images"].shape[1:3]),
                            "images": int(batch["sample_valid"].sum()),
                            "ms": ms, "peak_gib":
                            torch.cuda.max_memory_allocated() / 2 ** 30,
                            "scalars": {
                                k: float(v) for k, v in scalars.items()
                                if v.dim() == 0}})
                    return state, scalars
                return train_step
            return make_step

        def counted_eval(make):
            def make_step(*args, **kwargs):
                step = make(*args, **kwargs)

                def eval_step(*args):
                    batch = args[-1]
                    run = self.evals[-1]
                    run["calls"].append(time.perf_counter())
                    before = read_counts()
                    res = step(*args)
                    after = read_counts()
                    run["parts"]["eval_step"] = run["parts"].get(
                        "eval_step", 0.0) + (time.perf_counter()
                                             - run["calls"][-1])
                    run["launches"].append({k: after[k] - before[k]
                                            for k in after})
                    run["images"].append(int(batch["sample_valid"].sum()))
                    if len(run["calls"]) == 1:      # first batch: kept
                        self.first_dets.append({
                            k: res["post"][k].clone()
                            for k in ("scores", "boxes")})
                        if "pred_masks" in res:
                            self.first_dets[-1]["pred_masks"] = \
                                res["pred_masks"].clone()
                    return res
                return eval_step
            return make_step

        def timed_evaluate(evaluate):
            def run(*args, **kwargs):
                self.evals.append({"calls": [], "launches": [],
                                   "images": [], "parts": {}, "masks": []})
                start = time.perf_counter()
                out = evaluate(*args, **kwargs)
                self.evals[-1]["end"] = end = time.perf_counter()
                self.evals[-1]["results"] = out
                parts = self.evals[-1]["parts"]
                parts["other"] = end - start - sum(parts.values())
                return out
            return run

        def timed(part):
            # Host seconds of one part of evaluate, summed over its calls.
            def wrap(fn):
                def run(*args, **kwargs):
                    t = time.perf_counter()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        if self.evals:
                            parts = self.evals[-1]["parts"]
                            parts[part] = parts.get(part, 0.0) + (
                                time.perf_counter() - t)
                return run
            return wrap

        def kept_restore(restore):
            def run(*args, **kwargs):
                state, epoch = restore(*args, **kwargs)
                self.restored.append(state)
                return state, epoch
            return run

        def no_sync(name):
            def wrap(fn):
                def run(*args, **kwargs):
                    self.cluster_calls += 1
                    key = name if kwargs.get("train", True) else \
                        f"{name}_eval"
                    self.cluster_inputs[key] = (_detached(args), kwargs)
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                return run
            return wrap

        def mask_timings(finish):
            # Each eval batch's mask postprocess: device ms (CUDA events),
            # copy and host RLE ms, overflowing samples.
            def run(handle, timings=None):
                t = {}
                out = finish(handle, timings=t)
                self.evals[-1]["masks"].append(t)
                return out
            return run

        def first_softkd(solve):
            def run(cost, n):
                if self.softkd_problem is None:
                    self.softkd_problem = (cost.detach().clone(), n.clone())
                return solve(cost, n)
            return run

        patch(pmain, "make_train_step", counted_train)
        patch(pmain, "make_eval_step", counted_eval)
        patch(engine, "evaluate", timed_evaluate)
        patch(ckpt, "restore", kept_restore)
        if distill or seg:
            patch(pmain, "make_cluster_eval_step", counted_eval)
            for name in ("teacher_update_and_snap", "student_cluster"):
                patch(cl, name, no_sync(name))
        if distill:
            patch(pmain, "make_distillation_train_step", counted_train)
            patch(crit, "solve_lsa_batch", first_softkd)
        if seg:
            patch(engine, "finish_masks_device", mask_timings)
        # Where evaluate's host time goes: the eval step (the forward's
        # launches, the criterion and its matching), the wait for each
        # batch's copies (the device's time beyond what the next batch
        # overlaps), TaskEvaluator.update and .summarize (COCO scoring);
        # "other" is the rest, mostly the wait for the loader's batches.
        patch(engine, "finish_to_host", timed("copy_wait"))
        patch(engine.TaskEvaluator, "update", timed("update"))
        patch(engine.TaskEvaluator, "summarize", timed("summarize"))

    def undo(self):
        for obj, name, orig in reversed(self.undo_list):
            setattr(obj, name, orig)


def _detached(x):
    """x with every tensor in it (in tuples, lists, dicts) detached."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, (tuple, list)):
        return type(x)(_detached(v) for v in x)
    if isinstance(x, dict):
        return {k: _detached(v) for k, v in x.items()}
    return x


def _models(state):
    """("student", False), and ("teacher", True) when there is one."""
    return [("student", False)] + ([("teacher", True)]
                                   if state.teacher is not None else [])


def _snapshot(state):
    """Copies of what phases 12 and 13 check moved: each model's masters
    and EMA, and its frozen parameters."""
    from toist_tpu_torch.train.state import model_masters

    snap = {}
    for who, teacher in _models(state):
        model = state.teacher if teacher else state.model
        ema = state.teacher_ema if teacher else state.ema
        snap[who] = {
            "masters": {n: m.detach().clone()
                        for n, _, m in model_masters(state, teacher)},
            "ema": {n: e.clone() for n, e in ema.items()},
            "frozen": {n: p.detach().clone()
                       for n, p in model.named_parameters()
                       if not p.requires_grad}}
    return snap


def _distill_step_record(state, batch, scalars, ms, bank0):
    """One distillation step: its ms, canvas and pairs, the bank's growth
    against the valid noun samples with a noun span on a valid box (what
    ``teacher_update_and_snap`` pushes), its scalars."""
    noun = batch["noun"]
    spans = noun["noun_token_spans"]
    pushed = (noun["box_valid"] & (spans[..., 0] >= 0)
              & (spans[..., 1] >= spans[..., 0])).any(-1) \
        & noun["sample_valid"]
    return {"canvas": list(noun["images"].shape[1:3]),
            "pairs": int(noun["sample_valid"].sum()), "ms": ms,
            "bank_growth": state.cluster_bank.update_count.sum().item()
            - bank0,
            "pushed": int(pushed.sum()),
            "scalars": {k: float(v) for k, v in scalars.items()
                        if v.dim() == 0}}


def _states_equal(a, b):
    """Names of the parts of two TrainStates that differ (bit for bit)."""
    import dataclasses

    bad = []
    if a.step != b.step:
        bad.append("step")
    if len(a.masters) != len(b.masters) or any(
            not (_equal(pa, pb) and _equal(ma, mb))
            for (pa, ma), (pb, mb) in zip(a.masters, b.masters)):
        bad.append("masters")
    for name in ("ema", "teacher_ema"):
        ea, eb = getattr(a, name), getattr(b, name)
        if (ea is None) != (eb is None) or list(ea or ()) != list(
                eb or ()) or any(not _equal(ea[n], eb[n]) for n in ea or ()):
            bad.append(name)
    if (a.cluster_bank is None) != (b.cluster_bank is None) or (
            a.cluster_bank is not None and any(
                not _equal(getattr(a.cluster_bank, f.name),
                           getattr(b.cluster_bank, f.name))
                for f in dataclasses.fields(a.cluster_bank))):
        bad.append("cluster_bank")
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    if set(sa["state"]) != set(sb["state"]) or any(
            not _equal(v, sb["state"][i][k])
            for i, s in sa["state"].items() for k, v in s.items()):
        bad.append("optimizer")
    return bad


def _equal(a, b):
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a, b.to(a.device))


def phase_main(smi, state_dict, root):
    """Phase 11: toist_tpu_torch.main, the user's entry point, at full
    width in bf16 on the fixture, from parse_args: run 1 trains one epoch
    (batch 6) from the seeded weights given through --load, writes
    checkpoint, evaluates (batch 8, eval_skip 1) and writes
    BEST_checkpoint; run 2 is --eval --resume <out>/checkpoint."""
    import numpy as np
    import torch

    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.train import checkpoint as ckpt

    cfg0 = _fixture_config(root)
    d = cfg0.data
    # The fixture's tokenizer has its own vocabulary: the word embeddings
    # are cut to it, as a user's --load must match the model's vocabulary.
    vocab = build_tokenizer(cfg0).vocab_size
    key = "transformer.text_encoder.embeddings.word_embeddings.weight"
    load = os.path.join(root, "seeded_weights.pth")
    torch.save({"model": dict(state_dict, **{key: state_dict[key][:vocab]})},
               load)
    out = os.path.join(root, "main_out")
    sets = [f"data.coco_path={d.coco_path}",
            f"data.refexp_ann_path={d.refexp_ann_path}", "data.tasks=[1,2]",
            f"data.num_workers={d.num_workers}", "optim.epochs=1",
            f"optim.train_batch_size={TRAIN_B}", f"optim.valid_batch_size={B}",
            "optim.eval_skip=1"]
    argv1 = ["--load", load, "--output-dir", out, "--set", *sets]
    argv2 = ["--eval", "--resume", os.path.join(out, "checkpoint"),
             "--set", *sets]
    hooks = _Hooks()
    n_saves = len(ckpt.SAVES)
    try:
        reset_counts()
        t0 = time.perf_counter()
        best = pmain.main(pmain.parse_args(argv1))
        t1 = time.perf_counter()
        run1_state = hooks.state
        m2 = pmain.main(pmain.parse_args(argv2))
        t2 = time.perf_counter()
        launches = read_counts()
    finally:
        hooks.undo()
    n_params = sum(p.numel() for p in run1_state.model.parameters())
    log(f"[main] run 1 (train 1 epoch, checkpoint, eval, best): "
        f"{t1 - t0:.2f} s; run 2 (--eval --resume): {t2 - t1:.2f} s; "
        f"{n_params} parameters (vocabulary {vocab}) | {smi}")

    with open(os.path.join(out, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    kinds = {r["kind"] for r in records}
    evals = [r for r in records if r["kind"] == "eval"]
    want_train = {"fwd": LAUNCHES_PER_FORWARD, "dkv": LAUNCHES_PER_FORWARD,
                  "dq": LAUNCHES_PER_FORWARD, "fwd_tc": LAUNCHES_PER_FORWARD,
                  "dkv_tc": LAUNCHES_PER_FORWARD,
                  "dq_tc": LAUNCHES_PER_FORWARD,
                  "dropout": 3 * LAUNCHES_PER_FORWARD, "lsa": 1}
    # Eval forward: the tensor-core forward only (f32 route = fwd - fwd_tc
    # = 0), no backward, one LSA for the eval losses.
    want_eval = {k: 0 for k in want_train}
    want_eval.update(fwd=LAUNCHES_PER_FORWARD, fwd_tc=LAUNCHES_PER_FORWARD,
                     lsa=1)
    bad_train = [c for c in hooks.train if c != want_train]
    bad_eval = [c for run in hooks.evals for c in run["launches"]
                if c != want_eval]
    diff = _states_equal(run1_state, hooks.restored[0]) \
        if hooks.restored else ["no restore"]
    det_err = {k: _rel_err(hooks.first_dets[1][k], hooks.first_dets[0][k])
               for k in ("scores", "boxes")}
    saves = [dict(s, path=os.path.basename(s["path"]))
             for s in ckpt.SAVES[n_saves:]]
    runs = []
    for run in hooks.evals:
        # Host clock from the second batch's call to evaluate's return (the
        # per-task COCO scoring included), the first batch left out.
        runs.append({"batches": len(run["calls"]),
                     "images": sum(run["images"]),
                     "img_s": sum(run["images"][1:])
                     / (run["end"] - run["calls"][1]),
                     "host_s_by_part": run["parts"]})
    res = {"train_steps": len(hooks.train), "eval_runs": runs,
           "mean_ap50": {"run1": best, "run2": m2,
                         "log": [r["mean_ap50"] for r in evals]},
           "checkpoints": saves, "resume_differs": diff,
           "first_eval_batch_rel_err": det_err, "launches": launches,
           "log_kinds": sorted(kinds)}
    log(f"[main] {json.dumps(res)} | {smi}")
    for s in saves:
        log(f"[main] {s['path']}: {s['bytes'] / 2**30:.3f} GiB, host copy "
            f"{s['copy_s']:.2f} s, write {s['write_s']:.2f} s | {smi}")
    for i, r in enumerate(runs):
        log(f"[main] run {i + 1} eval: {r['img_s']:.2f} img/s over "
            f"{r['batches']} batches of {B} (first left out), mean AP@0.5 "
            f"{(best, m2)[i]:.4f} (random weights: a smoke value) | {smi}")
    if (len(hooks.train) != 12 or bad_train or len(hooks.evals) != 2
            or any(r["batches"] != 8 for r in runs) or bad_eval
            or not {"train_step", "epoch", "eval"} <= kinds
            or not (np.isfinite(best) and np.isfinite(m2))
            or diff or max(det_err.values()) > REL_TOL["bfloat16"]
            or [s["path"] for s in saves] != ["checkpoint",
                                               "BEST_checkpoint"]):
        raise AssertionError(
            f"phase 11 (main): {res}; bad train steps {bad_train[:3]}, "
            f"bad eval steps {bad_eval[:3]}")
    res["eval_tc_launches"] = sum(c["fwd_tc"] for run in hooks.evals
                                  for c in run["launches"])
    return res


DISTILL_B = 3        # pairs per step (scripts/train_dete_dis.sh)
DISTILL_EVAL_B = 4   # the reference's distillation eval batch
DISTILL_SETS = ["loss.distillation=true", "loss.softkd_loss=true",
                "loss.softkd_coef=50", "loss.nsthl2_loss=true",
                "loss.cluster=true", "loss.cluster_num=3",
                "loss.cluster_memory_size=1024", "loss.kmeans_max_iters=32"]
KD_LOSSES = (["loss_softkd"] + [f"loss_softkd_{i}" for i in range(5)]
             + ["loss_nsthl2", "loss_cluster_feature"])


def phase_distill(smi, root, teacher_ckpt):
    """Phase 12: noun-pronoun distillation through toist_tpu_torch.main at
    full width in bf16 on the fixture: run 1 trains one epoch of 3 pairs
    (the student from phase 11's seeded weights by --load, the teacher from
    phase 11's checkpoint by run.load_noun; softkd, nsthl2, the cluster
    bank of [14, 1024, 256] with K 3 and 32 k-means iterations), writes
    checkpoint, runs the cluster eval (batch 4) and writes BEST_checkpoint;
    run 2 is --eval --resume <out>/checkpoint."""
    import numpy as np
    import torch

    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.train import checkpoint as ckpt

    d = _fixture_config(root).data
    load = os.path.join(root, "seeded_weights.pth")      # phase 11's --load
    out = os.path.join(root, "distill_out")
    sets = [f"data.coco_path={d.coco_path}",
            f"data.refexp_ann_path={d.refexp_ann_path}", "data.tasks=[1,2]",
            f"data.num_workers={d.num_workers}", "optim.epochs=1",
            f"optim.train_batch_size={DISTILL_B}",
            f"optim.valid_batch_size={DISTILL_EVAL_B}", "optim.eval_skip=1",
            f"run.load_noun={teacher_ckpt}", *DISTILL_SETS]
    argv1 = ["--load", load, "--output-dir", out, "--set", *sets]
    argv2 = ["--eval", "--resume", os.path.join(out, "checkpoint"),
             "--set", *sets]
    hooks = _Hooks(distill=True)
    n_saves = len(ckpt.SAVES)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        best = pmain.main(pmain.parse_args(argv1))
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        run1_state = hooks.state
        m2 = pmain.main(pmain.parse_args(argv2))
        t2 = time.perf_counter()
        launches = read_counts()
    finally:
        hooks.undo()
    log(f"[distill] run 1 (train 1 epoch, checkpoint, cluster eval, best): "
        f"{t1 - t0:.2f} s; run 2 (--eval --resume): {t2 - t1:.2f} s | {smi}")

    with open(os.path.join(out, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    kinds = {r["kind"] for r in records}
    want_train = {k: 2 * LAUNCHES_PER_FORWARD for k in
                  ("fwd", "dkv", "dq", "fwd_tc", "dkv_tc", "dq_tc")}
    want_train.update(dropout=6 * LAUNCHES_PER_FORWARD, lsa=3)
    want_eval = {k: 0 for k in want_train}
    want_eval.update(fwd=LAUNCHES_PER_FORWARD, fwd_tc=LAUNCHES_PER_FORWARD,
                     lsa=1)
    bad_train = [c for c in hooks.train if c != want_train]
    bad_eval = [c for run in hooks.evals for c in run["launches"]
                if c != want_eval]
    bad_losses = [st for st in hooks.steps
                  if not all(math.isfinite(v) for v in st["scalars"].values())
                  or not set(KD_LOSSES) <= set(st["scalars"])]
    bad_bank = [st for st in hooks.steps if st["bank_growth"] != st["pushed"]]
    diff = _states_equal(run1_state, hooks.restored[0]) \
        if hooks.restored else ["no restore"]
    det_err = {k: _rel_err(hooks.first_dets[1][k], hooks.first_dets[0][k])
               for k in ("scores", "boxes")}
    moved = _moved(hooks.first, run1_state)
    saves = [dict(s, path=os.path.basename(s["path"]))
             for s in ckpt.SAVES[n_saves:]]
    runs = [{"batches": len(run["calls"]), "images": sum(run["images"]),
             "img_s": sum(run["images"][1:]) / (run["end"] - run["calls"][1]),
             "host_s_by_part": run["parts"]} for run in hooks.evals]
    steps = hooks.steps
    pairs = sum(st["pairs"] for st in steps)
    step_s = sum(st["ms"] for st in steps) / 1e3
    res = {"train_steps": len(hooks.train), "eval_runs": runs,
           "mean_ap50": {"run1": best, "run2": m2,
                         "log": [r["mean_ap50"] for r in records
                                 if r["kind"] == "eval"]},
           "checkpoints": saves, "resume_differs": diff,
           "first_eval_batch_rel_err": det_err, "launches": launches,
           "log_kinds": sorted(kinds), "parameters": moved,
           "cluster_calls_without_sync": hooks.cluster_calls,
           "pairs_s": pairs / step_s, "peak_gib": peak,
           "bank_update_count": run1_state.cluster_bank.update_count.tolist(),
           "bank_full": run1_state.cluster_bank.full.tolist()}
    for st in steps:
        log(f"[distill] step {json.dumps(st)}")
    log(f"[distill] {json.dumps(res)} | {smi}")
    log(f"[distill] {len(steps)} steps, {pairs} pairs in {step_s:.3f} s: "
        f"{pairs / step_s:.3f} pairs/s, step ms "
        f"{sorted(round(st['ms'], 1) for st in steps)}, peak memory "
        f"{peak:.2f} GiB | {smi}")
    for sv in saves:
        log(f"[distill] {sv['path']}: {sv['bytes'] / 2**30:.3f} GiB, host "
            f"copy {sv['copy_s']:.2f} s, write {sv['write_s']:.2f} s | {smi}")
    for i, r in enumerate(runs):
        log(f"[distill] run {i + 1} cluster eval: {r['img_s']:.2f} img/s "
            f"over {r['batches']} batches of {DISTILL_EVAL_B} (first left "
            f"out), mean AP@0.5 {(best, m2)[i]:.4f} (a smoke value) | {smi}")
    path_counts = {k: launches[k] for k in ("fwd_tc", "dkv_tc", "dq_tc",
                                            "dropout", "lsa")}
    if (len(steps) < 5 or bad_train or bad_losses or bad_bank
            or len(hooks.evals) != 2 or any(r["batches"] != 16 for r in runs)
            or bad_eval or not {"train_step", "epoch", "eval"} <= kinds
            or not (np.isfinite(best) and np.isfinite(m2))
            or diff or max(det_err.values()) > REL_TOL["bfloat16"]
            or not moved["ok"] or not all(path_counts.values())
            or hooks.cluster_calls < 2 * len(steps) + 32
            or [sv["path"] for sv in saves] != ["checkpoint",
                                                "BEST_checkpoint"]):
        raise AssertionError(
            f"phase 12 (distillation): {res}; bad train steps "
            f"{bad_train[:3]}, bad eval steps {bad_eval[:3]}, bad losses "
            f"{bad_losses[:2]}, bank growth {bad_bank[:2]}")
    res["eval_tc_launches"] = sum(c["fwd_tc"] for run in hooks.evals
                                  for c in run["launches"])
    hooks.restored.clear()
    torch.cuda.empty_cache()

    res["cluster"] = _cluster_costs(smi, hooks.cluster_inputs)
    cfg = pmain.parse_args(argv1)
    it = _paired_iterator(cfg)
    from toist_tpu_torch.train.criterion import build_weight_dict
    from toist_tpu_torch.train.distill import make_distillation_train_step
    step = make_distillation_train_step(
        cfg, build_weight_dict(cfg.loss, False, cfg.model.dec_layers))
    top = max({tuple(st["canvas"]) for st in steps},
              key=lambda hw: hw[0] * hw[1])
    res["profile"] = _profile_steps(smi, step, run1_state, it, top,
                                    label="distillation")
    first_batch = next(it.epoch(0, num_workers=1))
    return res, run1_state, first_batch, hooks.softkd_problem


def _moved(first, state):
    """Whether each model's trainable parameters all changed, its frozen
    ones did not, and its EMA moved, against the snapshot ``first``."""
    import torch

    from toist_tpu_torch.train.state import model_masters

    out = {"ok": True}
    for who, teacher in _models(state):
        model = state.teacher if teacher else state.model
        ema = state.teacher_ema if teacher else state.ema
        masters = {n: m for n, _, m in model_masters(state, teacher)}
        params = dict(model.named_parameters())
        snap = first[who]
        changed = sum(not torch.equal(snap["masters"][n], m)
                      for n, m in masters.items())
        frozen_moved = [n for n, p in snap["frozen"].items()
                        if not torch.equal(p, params[n])]
        ema_moved = sum(not torch.equal(snap["ema"][n], e)
                        for n, e in ema.items())
        out[who] = {"trainable": len(masters), "changed": changed,
                    "frozen": len(snap["frozen"]),
                    "frozen_moved": frozen_moved[:5],
                    "ema_moved": ema_moved}
        out["ok"] &= (changed == len(masters) > 0 and not frozen_moved
                      and len(snap["frozen"]) > 0
                      and ema_moved == len(masters))
    return out


def _paired_iterator(cfg):
    """The distillation training batches of ``cfg`` (paired noun/sth)."""
    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.data.batcher import BatchIterator
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.cocotasks import build_task_dataset

    tokenizer = build_tokenizer(cfg)
    train_spec, _ = pmain.build_specs(cfg)
    datasets = [build_task_dataset(cfg.data, t, "train", tokenizer,
                                   distillation=True)
                for t in cfg.data.tasks]
    return BatchIterator(datasets, train_spec, batch_size=DISTILL_B,
                         seed=cfg.run.seed, paired=True,
                         num_workers=cfg.data.num_workers)


def _cluster_costs(smi, inputs):
    """The cluster bank's calls of one distillation step, replayed on the
    last step's inputs: device kernel launches and the sum of their kernel
    ms (torch.profiler), and host ms per call (host clock with a sync); the
    same for one k-means call on a task's bank, and its launches per step
    (B teacher + B student samples). device_ms cannot time these calls: a
    call queues more kernels than the launch queue holds behind its spin."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from toist_tpu_torch.ops.kmeans import kmeans
    from toist_tpu_torch.train import cluster as cl

    def profiled(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        us = [getattr(e, "self_device_time_total", None) for e in events]
        us = [e.self_cuda_time_total if u is None else u
              for e, u in zip(events, us)]
        return sum(e.count for e in events), sum(us) / 1e3

    def host_ms(fn, n=5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    args_t, kw_t = inputs["teacher_update_and_snap"]
    args_s, kw_s = inputs["student_cluster"]
    bank = args_t[0]
    calls = {
        "teacher_update_and_snap": lambda: cl.teacher_update_and_snap(
            *args_t, **kw_t),
        "student_cluster": lambda: cl.student_cluster(*args_s, **kw_s),
        "kmeans": lambda: kmeans(bank.feature_bank[0],
                                 bank.cluster_centers[0], 32)}
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            fn()
            n, kernel_ms = profiled(fn)
            out[name] = {"launches": n, "kernel_ms": kernel_ms or
                         "not measured", "host_ms": host_ms(fn)}
    out["kmeans"]["calls_per_step"] = 2 * DISTILL_B
    out["kmeans_launches_per_step"] = 2 * DISTILL_B \
        * out["kmeans"]["launches"]
    out["cluster_launches_per_step"] = (
        out["teacher_update_and_snap"]["launches"]
        + out["student_cluster"]["launches"])
    log(f"[distill] cluster bank per step (replayed on the last step's "
        f"inputs, bank {list(bank.feature_bank.shape)}, K "
        f"{bank.cluster_centers.shape[1]}, 32 iterations): "
        f"{json.dumps(out)} | {smi}")
    return out


# Gradients that are 0 by construction (RoBERTa's key biases, the first
# decoder self-attention's) against their partner's, in the f32
# distillation step. f32 rounding of the reference's 1e4-weighted feature
# losses (nsthl2, cluster) puts them at 1.2e-4 to 1.8e-4 in the plain run
# as in the kernels' (5.4e-5 with those weights at 1); neither passes
# through a kernel.
ZERO_TOL = 1e-3
# The smallest loss scale in that step: softkd between two random models is
# a KL of near-equal distributions (2e-6 at the main level), whose sum the
# kernels' f32 rounding moves by 3e-9, 1e-3 of itself.
LOSS_ABS = 1e-3


def _attention_f64(q, k, v, key_padding_mask, num_heads, dropout_keep=None,
                   dropout_rate=0.0):
    """``attention_plain`` at rate 0 computed in f64, its output cast back
    to q's dtype: the reference for a gradient's f32 floor."""
    import torch

    from toist_tpu_torch.ops.flash_attention import NEG_INF

    assert dropout_keep is None
    B, Sq, D = q.shape
    hd = D // num_heads
    qh, kh, vh = (t.double().reshape(B, -1, num_heads, hd).transpose(1, 2)
                  for t in (q, k, v))
    logits = qh @ kh.transpose(-1, -2) / math.sqrt(hd)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                    NEG_INF)
    out = torch.softmax(logits, dim=-1) @ vh
    return out.transpose(1, 2).reshape(B, Sq, D).to(q.dtype), None


def phase_distill_kernel_vs_plain(student_sd, teacher_sd, bank0, batch):
    """One f32 distillation step (dropout 0) of the student and teacher
    weights (reference-layout state dicts) from the bank ``bank0``: with
    the kernels, and the same step with the plain attention and the plain
    LSA. The kernel run's three
    solves (the noun and sth matchers, the softkd re-pairing) are held
    against the plain solver on the same costs (equal assignments, or equal
    total cost on ties); the plain run takes the kernel run's assignments
    (one matching), and a problem that its own costs would match otherwise
    must be a near-tie (costs within 1e-4 on the kernel run's costs).
    Losses within 1e-4 of max(|loss|, LOSS_ABS), the gradients of both
    models within 2e-3 of each tensor's max abs. A third run, the plain one
    with every attention computed in f64, gives each loss's and gradient's
    f32 floor: a gradient whose plain f32 value is itself that far from the
    f64 run's (a sum that nearly cancels) is held to twice its floor
    instead. The gradients that are 0 by construction are held to ZERO_TOL
    of their partner's."""
    import dataclasses

    import torch

    from toist_tpu_torch.config import Config
    from toist_tpu_torch.models import layers
    from toist_tpu_torch.models.layers import set_fused_attention
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.ops import lsa
    from toist_tpu_torch.ops.flash_attention import attention_plain
    from toist_tpu_torch.ops import matching
    from toist_tpu_torch.train import criterion as crit
    from toist_tpu_torch.train.cluster import ClusterBank
    from toist_tpu_torch.train.distill import distillation_losses
    from toist_tpu_torch.train.state import init_train_state, model_masters
    from toist_tpu_torch.train.step import (accumulate_gradients,
                                            train_batch_to_device)

    cfg = Config.from_sources(None, {
        "model": {"compute_dtype": "float32", "dropout": 0.0,
                  "resizer_dropout": 0.0},
        "loss": {"distillation": True, "softkd_loss": True,
                 "nsthl2_loss": True, "cluster": True}})
    wd = crit.build_weight_dict(cfg.loss, False, cfg.model.dec_layers)
    student = TOIST.from_state_dict(student_sd, cfg.model, device="cuda")
    teacher = TOIST.from_state_dict(teacher_sd, cfg.model, device="cuda")
    x = train_batch_to_device(batch, "cuda")
    solves = []

    def total_cost(cost, a, n):
        rows = torch.arange(int(n))
        return cost[rows, a[:int(n)].long()].sum().item()

    def recording(cost, n):
        got = lsa.solve_lsa_batch(cost, n)
        solves.append([t.detach().cpu() for t in (cost, n, got)]
                      + [lsa.solve_lsa_batch_plain(cost, n).cpu()])
        return got

    replayed = []

    def replaying(cost, n):
        c_k, n_k, a_k, _ = solves[len(replayed)]
        a_p = lsa.solve_lsa_batch_plain(cost, n).cpu()    # numpy, host
        gaps = [abs(total_cost(c_k[i], a_k[i], n_k[i])
                    - total_cost(c_k[i], a_p[i], n_k[i]))
                / max(1.0, abs(total_cost(c_k[i], a_k[i], n_k[i])))
                for i in (a_k != a_p).any(-1).nonzero().flatten().tolist()]
        replayed.append(gaps)
        return a_k.to(cost.device)

    def run(fused, solve):
        for m in (student, teacher):
            set_fused_attention(m, fused)
        st = init_train_state(student, cfg, 1, 1, teacher=teacher,
                              cluster_bank=ClusterBank(**{
                                  f.name: getattr(bank0, f.name).clone()
                                  for f in dataclasses.fields(bank0)}))
        old = (matching.solve_lsa_batch, crit.solve_lsa_batch)
        matching.solve_lsa_batch = crit.solve_lsa_batch = solve
        try:
            reset_counts()
            sc = accumulate_gradients(st, x, cfg, wd, distillation_losses)
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            matching.solve_lsa_batch, crit.solve_lsa_batch = old
        grads = {(w, n): m.grad.detach().clone()
                 for w, t in (("student", False), ("teacher", True))
                 for n, _, m in model_masters(st, t)}
        for _, m in st.masters:
            m.grad = None
        return {k: float(v) for k, v in sc.items()}, grads, counts

    lk, gk, with_kernels = run(True, recording)
    lp, gp, without = run(False, replaying)
    replayed_f32 = list(replayed)
    replayed.clear()
    layers.attention_plain = _attention_f64
    try:
        l64, g64, _ = run(False, replaying)
    finally:
        layers.attention_plain = attention_plain
    replayed[:] = replayed_f32
    solver = []
    for (c, n, got, plain), name in zip(solves, ("noun matcher",
                                                 "sth matcher", "softkd")):
        differ = (got != plain).any(-1).nonzero().flatten().tolist()
        gap = max((abs(total_cost(c[i], got[i], n[i])
                       - total_cost(c[i], plain[i], n[i]))
                   / max(1.0, abs(total_cost(c[i], plain[i], n[i])))
                   for i in differ), default=0.0)
        solver.append({"site": name, "shape": list(c.shape),
                       "problems_differing": len(differ),
                       "their_max_rel_cost_gap": gap})
    def rel_loss(a, b):
        return abs(a - b) / max(abs(b), LOSS_ABS)

    # The losses (the cardinality errors are counts, for logging), each
    # beside its f32 floor.
    loss_errs = {k: (rel_loss(lk[k], lp[k]), rel_loss(lp[k], l64[k]))
                 for k in lk if "loss" in k}
    loss_err = max(e for e, _ in loss_errs.values())
    first_sa = "transformer.decoder.layers.0.self_attn.in_proj_weight"
    zero = [k for k in gp if k[1].endswith(".key.bias") or k[1] == first_sa]
    partner = {k: (k[0], k[1][:-len("weight")] + "bias"
                   if k[1].endswith("weight") else
                   k[1][:-len("bias")] + "weight") for k in zero}
    noise = max((max(g[k].abs().max().item() for g in (gk, gp))
                 / gp[partner[k]].abs().max().item() for k in zero),
                default=0.0)

    def rel(a, b):
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-12)

    grad_errs = sorted((rel(gk[k], gp[k]), k) for k in gp if k not in zero)
    floor = {k: rel(gp[k], g64[k]) for _, k in grad_errs}
    over = [(e, k) for e, k in grad_errs
            if e > STEP_GRAD_TOL and e > 2 * floor[k]]
    want = {k: 2 * LAUNCHES_PER_FORWARD for k in ("fwd", "dkv", "dq")}
    want.update(fwd_tc=0, dkv_tc=0, dq_tc=0, dropout=0, lsa=3)
    res = {"solver_vs_plain_on_same_costs": solver,
           "problems_matched_differently_across_runs":
               [len(g) for g in replayed],
           "their_max_rel_cost_gap": max((x for g in replayed for x in g),
                                         default=0.0),
           "total_loss": {"kernels": lk["loss"], "plain": lp["loss"]},
           "kd_losses": {k: [lk[k], lp[k]] for k in KD_LOSSES},
           "loss_max_rel_err": loss_err,
           "loss_f32_floor": max(f for _, f in loss_errs.values()),
           "kd_loss_errs_and_floors": {k: loss_errs[k] for k in KD_LOSSES},
           "grad_max_rel_err": grad_errs[-1][0],
           "worst_grads": [(e, "/".join(k)) for e, k in grad_errs[-8:]],
           "grads_over_tol": [(e, floor[k], "/".join(k)) for e, k in
                              grad_errs if e > STEP_GRAD_TOL],
           "grads_over_tol_and_twice_floor": len(over),
           "max_f32_floor": max(floor.values()),
           "grads_compared": len(grad_errs), "zero_by_construction":
               len(zero), "their_grad_over_partner_grad": noise,
           "launches_with": with_kernels, "launches_without": without}
    log(f"[distill-f32] kernels vs plain {json.dumps(res)} (tolerances: "
        f"losses {LOSS_RTOL} of max(|loss|, {LOSS_ABS}), gradients "
        f"{STEP_GRAD_TOL} or twice their f32 floor, zero by construction {ZERO_TOL}, cost gap 1e-4, solver "
        f"ties 1e-5)")
    if (len(solves) != 3 or len(replayed) != 3
            or any(s["their_max_rel_cost_gap"] > 1e-5 for s in solver)
            or solver[0]["problems_differing"]
            or solver[1]["problems_differing"]
            or res["their_max_rel_cost_gap"] > 1e-4
            or loss_err > LOSS_RTOL or over
            or noise > ZERO_TOL or set(gk) != set(gp)
            or {w for w, _ in gk} != {"student", "teacher"}
            or with_kernels != want or any(without.values())):
        raise AssertionError(f"distillation step kernels vs plain: {res}")
    return res


SEG_TRAIN_B = 2      # scripts/train_seg.sh
SEG_EVAL_B = 4       # scripts/eval_seg.sh
SEG_SETS = ["model.mask_model=smallconv", "model.frozen_detector=true",
            "loss.aux_loss=false", "model.contrastive_align_loss=false"]
# Per frozen-detector training step: the forward only (with dropout), no
# attention backward, one matcher solve.
SEG_TRAIN_LAUNCHES = {"fwd": LAUNCHES_PER_FORWARD, "dkv": 0, "dq": 0,
                      "fwd_tc": LAUNCHES_PER_FORWARD, "dkv_tc": 0, "dq_tc": 0,
                      "dropout": LAUNCHES_PER_FORWARD, "lsa": 1}
SEG_EVAL_LAUNCHES = {"fwd": LAUNCHES_PER_FORWARD, "dkv": 0, "dq": 0,
                     "fwd_tc": LAUNCHES_PER_FORWARD, "dkv_tc": 0, "dq_tc": 0,
                     "dropout": 0, "lsa": 1}
MASK_HEAD = ("bbox_attention.", "mask_head.")


def _seg_eval_runs(hooks, batch_size):
    """Each evaluate of a seg run: img/s (host clock from the second batch,
    the first left out), host seconds by part, per batch the mask
    postprocess's device ms (CUDA events), copy and host RLE ms, the
    overflowing samples (packed path), and the bbox and mask AP@0.5 of each
    task (None where a task has no segm stats)."""
    runs = []
    for run in hooks.evals:
        masks = run["masks"]
        ap = {str(t): {k: float(st[k][1]) if k in st else None
                       for k in ("bbox", "segm")}
              for t, st in run["results"].items()}

        def mean(key):
            vals = [t[key] for t in masks if key in t]
            return sum(vals) / len(vals) if vals else "not measured"
        runs.append({
            "batches": len(run["calls"]), "batch_size": batch_size,
            "images": sum(run["images"]),
            "img_s": sum(run["images"][1:]) / (run["end"] - run["calls"][1]),
            "host_s_by_part": run["parts"],
            "eval_step_ms_per_batch": run["parts"].get("eval_step", 0.0)
            * 1e3 / max(1, len(run["calls"])),
            "mask_device_ms_per_batch": mean("device_ms"),
            "mask_copy_ms_per_batch": mean("copy_ms"),
            "mask_host_rle_ms_per_batch": mean("host_rle_ms"),
            "mask_pulled_mb_per_batch": mean("packed_mb"),
            "overflow_samples": sum(t.get("n_overflow_samples", 0)
                                    for t in masks),
            "ap50": ap,
            "segm_ok": len(ap) == 2 and all(
                v["segm"] is not None and math.isfinite(v["segm"])
                for v in ap.values())})
    return runs


def _seg_eval_records(out):
    """log.jsonl of a seg run: (kinds, eval records, whether each eval has
    segm stats for every task with a finite mask AP@0.5 and the mean
    map@0.5_masks)."""
    with open(os.path.join(out, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    evals = [r for r in records if r["kind"] == "eval"]
    ok = bool(evals) and all(
        len(r["per_task"]) == 2 and math.isfinite(r.get(
            "map@0.5_masks", math.nan))
        and all("segm" in st and math.isfinite(st["segm"][1])
                for st in r["per_task"].values())
        for r in evals)
    return {r["kind"] for r in records}, evals, ok


def phase_seg(smi, root, det_ckpt, dis_ckpt):
    """Phase 13: segmentation through toist_tpu_torch.main at full width in
    bf16 on the fixture. Run 1 is train_seg (scripts/train_seg.sh): phase
    11's detection checkpoint by --load, the mask head only (frozen
    detector), batch 2, one epoch, checkpoint, bbox + segm eval (batch 4),
    BEST_checkpoint; run 2 is eval_seg (--eval --resume); run 3 is
    train_seg_dis then eval_seg_dis (phase 12's checkpoint by --load,
    loss.cluster=true)."""
    import numpy as np
    import torch

    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.train import checkpoint as ckpt
    from toist_tpu_torch.train.state import model_masters

    d = _fixture_config(root).data
    out = os.path.join(root, "seg_out")
    sets = [f"data.coco_path={d.coco_path}",
            f"data.refexp_ann_path={d.refexp_ann_path}", "data.tasks=[1,2]",
            f"data.num_workers={d.num_workers}", "optim.epochs=1",
            f"optim.train_batch_size={SEG_TRAIN_B}",
            f"optim.valid_batch_size={SEG_EVAL_B}", "optim.eval_skip=1",
            *SEG_SETS]
    argv1 = ["--load", det_ckpt, "--output-dir", out, "--set", *sets]
    argv2 = ["--eval", "--resume", os.path.join(out, "checkpoint"),
             "--set", *sets]
    out3 = os.path.join(root, "seg_dis_out")
    argv3 = ["--load", dis_ckpt, "--output-dir", out3, "--set", *sets,
             "loss.cluster=true"]
    hooks = _Hooks(seg=True)
    n_saves = len(ckpt.SAVES)
    # What earlier phases still hold on the card counts in every peak below.
    resident = torch.cuda.memory_allocated() / 2 ** 30
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        best = pmain.main(pmain.parse_args(argv1))
        t1 = time.perf_counter()
        peak_eval = torch.cuda.max_memory_allocated() / 2 ** 30
        run1_state = hooks.state
        m2 = pmain.main(pmain.parse_args(argv2))
        t2 = time.perf_counter()
        launches = read_counts()
    finally:
        hooks.undo()
    log(f"[seg] run 1 (train_seg 1 epoch, checkpoint, eval, best): "
        f"{t1 - t0:.2f} s; run 2 (eval_seg: --eval --resume): "
        f"{t2 - t1:.2f} s | {smi}")
    steps = hooks.steps
    kinds, evals, segm_ok = _seg_eval_records(out)
    bad_train = [c for c in hooks.train if c != SEG_TRAIN_LAUNCHES]
    bad_eval = [c for run in hooks.evals for c in run["launches"]
                if c != SEG_EVAL_LAUNCHES]
    bad_losses = [st for st in steps
                  if not all(math.isfinite(v) for v in st["scalars"].values())
                  or not {"loss_mask", "loss_dice"} <= set(st["scalars"])]
    trainable = {n for n, _, _ in model_masters(run1_state)}
    moved = _moved(hooks.first, run1_state)
    diff = _states_equal(run1_state, hooks.restored[0]) \
        if hooks.restored else ["no restore"]
    mask_err = _rel_err(hooks.first_dets[1]["pred_masks"],
                        hooks.first_dets[0]["pred_masks"])
    saves = [dict(sv, path=os.path.basename(sv["path"]))
             for sv in ckpt.SAVES[n_saves:]]
    runs = _seg_eval_runs(hooks, SEG_EVAL_B)
    n_img = sum(st["images"] for st in steps)
    step_s = sum(st["ms"] for st in steps) / 1e3
    res = {"train_steps": len(steps), "img_s": n_img / step_s,
           "step_ms": sorted(st["ms"] for st in steps),
           "peak_gib_train": max(st["peak_gib"] for st in steps),
           "peak_gib_with_eval": peak_eval, "resident_gib_before": resident,
           "eval_runs": runs,
           "mask_ap50": {"run1": [r["map@0.5_masks"] for r in evals],
                         "bbox_run1": best, "bbox_run2": m2},
           "checkpoints": saves, "resume_differs": diff,
           "first_eval_batch_masks_rel_err": mask_err,
           "launches": launches, "log_kinds": sorted(kinds),
           "parameters": moved,
           "trainable": sorted({n.split(".")[0] for n in trainable})}
    for st in steps:
        log(f"[seg] step {json.dumps(st)}")
    log(f"[seg] {json.dumps(res)} | {smi}")
    log(f"[seg] {len(steps)} steps, {n_img} images in {step_s:.3f} s: "
        f"{n_img / step_s:.3f} img/s, step ms "
        f"{sorted(round(st['ms'], 1) for st in steps)}, "
        f"peak memory {res['peak_gib_train']:.2f} GiB (training), "
        f"{peak_eval:.2f} GiB (with the eval), of which {resident:.2f} GiB "
        f"held by earlier phases | {smi}")
    for sv in saves:
        log(f"[seg] {sv['path']}: {sv['bytes'] / 2**30:.3f} GiB, host copy "
            f"{sv['copy_s']:.2f} s, write {sv['write_s']:.2f} s | {smi}")
    for i, r in enumerate(runs):
        log(f"[seg] run {i + 1} eval: {r['img_s']:.2f} img/s over "
            f"{r['batches']} batches of {SEG_EVAL_B} (first left out); per "
            f"batch eval step {r['eval_step_ms_per_batch']:.1f} ms (host), "
            f"mask postprocess {r['mask_device_ms_per_batch']} ms (device), "
            f"copy {r['mask_copy_ms_per_batch']} ms, host RLE "
            f"{r['mask_host_rle_ms_per_batch']} ms; {r['overflow_samples']} "
            f"overflowing samples | {smi}")
    if (len(steps) < 5 or bad_train or bad_losses or len(hooks.evals) != 2
            or any(r["batches"] != 16 or not r["segm_ok"] for r in runs)
            or bad_eval
            or not {"train_step", "epoch", "eval"} <= kinds or not segm_ok
            or not (np.isfinite(best) and np.isfinite(m2))
            or {n.split(".")[0] + "." for n in trainable} != set(MASK_HEAD)
            or not moved["ok"] or diff or mask_err > REL_TOL["bfloat16"]
            or [sv["path"] for sv in saves] != ["checkpoint",
                                                "BEST_checkpoint"]):
        raise AssertionError(
            f"phase 13 (segmentation): {res}; bad train steps "
            f"{bad_train[:3]}, bad eval steps {bad_eval[:3]}, bad losses "
            f"{bad_losses[:2]}")
    res["eval_tc_launches"] = sum(c["fwd_tc"] for run in hooks.evals
                                  for c in run["launches"])
    train1 = hooks.train
    eval1 = [c for run in hooks.evals for c in run["launches"]]
    hooks.restored.clear()
    torch.cuda.empty_cache()

    # Run 3: train_seg_dis, then eval_seg_dis (the cluster eval with masks).
    hooks = _Hooks(seg=True)
    try:
        reset_counts()
        t0 = time.perf_counter()
        best3 = pmain.main(pmain.parse_args(argv3))
        t3 = time.perf_counter()
        launches3 = read_counts()
    finally:
        hooks.undo()
    kinds3, evals3, segm_ok3 = _seg_eval_records(out3)
    bad_train3 = [c for c in hooks.train if c != SEG_TRAIN_LAUNCHES]
    bad_eval3 = [c for run in hooks.evals for c in run["launches"]
                 if c != SEG_EVAL_LAUNCHES]
    bad_losses3 = [st for st in hooks.steps if not all(
        math.isfinite(v) for v in st["scalars"].values())]
    moved3 = _moved(hooks.first, hooks.state)
    runs3 = _seg_eval_runs(hooks, SEG_EVAL_B)
    res["dis"] = {"seconds": t3 - t0, "train_steps": len(hooks.steps),
                  "eval_runs": runs3, "launches": launches3,
                  "mask_ap50": [r["map@0.5_masks"] for r in evals3],
                  "bbox_ap50": best3, "parameters": moved3,
                  "cluster_calls_without_sync": hooks.cluster_calls}
    log(f"[seg] run 3 (train_seg_dis 1 epoch, eval_seg_dis): "
        f"{json.dumps(res['dis'])} | {smi}")
    if (len(hooks.steps) < 5 or bad_train3 or bad_losses3 or bad_eval3
            or len(runs3) != 1 or runs3[0]["batches"] != 16
            or not runs3[0]["segm_ok"] or not segm_ok3 or not moved3["ok"]
            or not math.isfinite(best3)
            or hooks.cluster_calls != len(hooks.steps) + 16):
        raise AssertionError(
            f"phase 13 (train_seg_dis): {res['dis']}; bad train steps "
            f"{bad_train3[:3]}, bad eval steps {bad_eval3[:3]}")
    res["dis"]["eval_tc_launches"] = sum(c["fwd_tc"] for run in hooks.evals
                                         for c in run["launches"])
    # Each kernel's launches over the phase's training steps and its eval
    # batches (runs 1-3).
    per_step = hooks.train + train1
    per_batch = [c for run in hooks.evals for c in run["launches"]] + eval1
    res["train_launches"] = {k: sum(c[k] for c in per_step)
                             for k in SEG_TRAIN_LAUNCHES}
    res["eval_launches"] = {k: sum(c[k] for c in per_batch)
                            for k in SEG_EVAL_LAUNCHES}
    del hooks
    torch.cuda.empty_cache()

    cfg = pmain.parse_args(argv1)
    res["profile"] = _seg_profile(smi, cfg, run1_state, steps)
    del run1_state
    torch.cuda.empty_cache()
    weights = ckpt.load_params(os.path.join(out, "checkpoint"))
    res["f32_kernel_vs_plain"] = phase_seg_kernel_vs_plain(cfg, weights)
    res["predictor"] = _seg_predictor(smi, cfg, weights)
    return res


def _seg_profile(smi, cfg, state, steps):
    """torch.profiler over 3 seg training steps on run 1's largest canvas,
    with a record_function range around compute_masks (the mask head's
    forward)."""
    import torch

    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.data.batcher import BatchIterator
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.cocotasks import build_task_dataset
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.train.criterion import build_weight_dict
    from toist_tpu_torch.train.step import make_train_step

    tokenizer = build_tokenizer(cfg)
    train_spec, _ = pmain.build_specs(cfg)
    datasets = [build_task_dataset(cfg.data, t, "train", tokenizer,
                                   masks=True) for t in cfg.data.tasks]
    it = BatchIterator(datasets, train_spec, batch_size=SEG_TRAIN_B,
                       seed=cfg.run.seed, num_workers=cfg.data.num_workers)
    step = make_train_step(cfg, build_weight_dict(
        cfg.loss, True, cfg.model.dec_layers))
    top = max({tuple(st["canvas"]) for st in steps},
              key=lambda hw: hw[0] * hw[1])
    orig = TOIST.compute_masks

    def ranged(self, *args, **kwargs):
        with torch.profiler.record_function("compute_masks"):
            return orig(self, *args, **kwargs)

    TOIST.compute_masks = ranged
    try:
        res = _profile_steps(smi, step, state, it, top, label="seg",
                             ranges=("compute_masks",))
    finally:
        TOIST.compute_masks = orig
    span = res.get("range_device_ms_per_step", {}).get("compute_masks")
    if isinstance(span, float) and isinstance(res["kernel_ms_per_step"],
                                              float):
        res["mask_head_forward_share"] = span / res["kernel_ms_per_step"]
    log(f"[seg] profile: mask head forward span {span} ms per step, share "
        f"{res.get('mask_head_forward_share', 'not measured')} of the "
        f"kernel ms | {smi}")
    return res


def _non_knife_pixels(logits, size, orig, got, want, tol=1e-5):
    """The pixels at which two RLE lists of one sample differ although
    their bilinear logit (float64, the device path's two-tap vectors) lies
    ``tol`` or more from the threshold 0."""
    import numpy as np

    from toist_tpu_torch.models.postprocess import _interp_vectors
    from toist_tpu_torch.ops import rle

    ch, cw = max(1, int(size[0]) // 4), max(1, int(size[1]) // 4)
    oh, ow = int(orig[0]), int(orig[1])
    iy0, iy1, ly0, ly1 = _interp_vectors(oh, ch)
    ix0, ix1, lx0, lx1 = _interp_vectors(ow, cw)
    bad = 0
    for q, (a, b) in enumerate(zip(got, want)):
        if a["counts"] == b["counts"]:
            continue
        m = logits[q].astype(np.float64)
        rows = (m[iy0] * ly0.astype(np.float64)[:, None]
                + m[iy1] * ly1.astype(np.float64)[:, None])
        v = (rows[:, ix0] * lx0.astype(np.float64)
             + rows[:, ix1] * lx1.astype(np.float64))
        diff = rle.decode(a) != rle.decode(b)
        bad += int((diff & (np.abs(v) >= tol)).sum())
    return bad


def phase_seg_kernel_vs_plain(cfg, weights):
    """One eval batch of 4 at 800x1344 in f32 (TF32 off) on run 1's
    weights, through the kernels and through the plain attention: the mask
    logits within SLICE_TOL of their max abs, logits and boxes within
    SLICE_TOL; the matcher's LSA kernel against the plain solver on the
    same costs (equal matchings); and the card's postprocess_masks_device
    against the same function on the CPU on the same logits (equal RLEs
    but for knife-edge pixels)."""
    import dataclasses

    import numpy as np
    import torch

    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.data.batcher import BatchIterator
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.cocotasks import build_task_dataset
    from toist_tpu_torch.models.layers import set_fused_attention
    from toist_tpu_torch.models.postprocess import postprocess_masks_device
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.ops.lsa import solve_lsa_batch
    from toist_tpu_torch.train import criterion as crit
    from toist_tpu_torch.train.step import (EVAL_KEYS, INPUT_KEYS,
                                            TARGET_KEYS, batch_to_device)

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    _, eval_spec = pmain.build_specs(cfg)
    ds = build_task_dataset(cfg.data, cfg.data.tasks[0], "val",
                            build_tokenizer(cfg), masks=True)
    batch = next(BatchIterator([ds], eval_spec, batch_size=SEG_EVAL_B,
                               shuffle=False).epoch(0))
    model = TOIST.from_state_dict(weights, cfg.model, device="cuda")
    x = batch_to_device(batch, "cuda", EVAL_KEYS + TARGET_KEYS)
    outs = {}
    with torch.inference_mode():
        for name, fused in (("kernels", True), ("plain", False)):
            set_fused_attention(model, fused)
            before = read_counts()
            out, cache = model(*(x[k] for k in INPUT_KEYS))
            out["pred_masks"] = model.compute_masks(cache, out["hs"][-1])
            after = read_counts()
            outs[name] = (out, {k: after[k] - before[k] for k in after})
        out = outs["kernels"][0]
        lsa0 = solve_lsa_batch.launches
        t2q_card = crit.set_criterion(out, x, cfg.loss)["_tgt2query"]
        lsa_launched = solve_lsa_batch.launches - lsa0
        cpu = lambda d: {k: v.cpu() for k, v in d.items()  # noqa: E731
                         if isinstance(v, torch.Tensor)}
        t2q_plain = crit.set_criterion(cpu(out), cpu(x),
                                       cfg.loss)["_tgt2query"]
    errs = {k: (outs["kernels"][0][k] - outs["plain"][0][k]).abs().max()
            .item() for k in ("pred_logits", "pred_boxes")}
    errs["pred_masks_rel"] = _rel_err(outs["kernels"][0]["pred_masks"],
                                      outs["plain"][0]["pred_masks"])
    logits = out["pred_masks"]
    t0 = time.perf_counter()
    timings = {}
    card = postprocess_masks_device(logits, batch["size"],
                                    batch["orig_size"],
                                    batch["sample_valid"], timings=timings)
    t1 = time.perf_counter()
    host = postprocess_masks_device(logits.cpu(), batch["size"],
                                    batch["orig_size"],
                                    batch["sample_valid"])
    t2 = time.perf_counter()
    l_np = logits.cpu().numpy()
    knife = {"masks": 0, "differing_masks": 0, "non_knife_pixels": 0}
    for b in range(len(card)):
        if card[b] is None or host[b] is None:
            knife["non_knife_pixels"] += int((card[b] is None)
                                             != (host[b] is None))
            continue
        knife["masks"] += len(card[b])
        knife["differing_masks"] += sum(a["counts"] != c["counts"]
                                        for a, c in zip(card[b], host[b]))
        knife["non_knife_pixels"] += _non_knife_pixels(
            l_np[b], batch["size"][b], batch["orig_size"][b], card[b],
            host[b])
    res = {"max_abs_err": errs, "tolerance": SLICE_TOL,
           "launches": {k: v[1] for k, v in outs.items()},
           "lsa_launches": lsa_launched,
           "matching_equal": bool(torch.equal(t2q_card.cpu(), t2q_plain)),
           "rle_vs_cpu": knife, "card_postprocess_s": t1 - t0,
           "cpu_postprocess_s": t2 - t1, "card_timings": timings,
           "canvas": list(batch["images"].shape[1:3])}
    log(f"[seg-f32] kernels vs plain on one eval batch: {json.dumps(res)}")
    set_fused_attention(model, True)
    if (max(errs["pred_logits"], errs["pred_boxes"]) > SLICE_TOL
            or errs["pred_masks_rel"] > SLICE_TOL
            or outs["kernels"][1]["fwd"] != LAUNCHES_PER_FORWARD
            or outs["plain"][1]["fwd"] != 0 or lsa_launched != 1
            or not res["matching_equal"] or knife["non_knife_pixels"]
            or knife["masks"] != 100 * int(batch["sample_valid"].sum())):
        raise AssertionError(f"segmentation kernels vs plain: {res}")
    return res


def _seg_predictor(smi, cfg, weights):
    """Predictor with a mask head (bf16) answers one batch of 4 PIL images
    at 800x1344: every kept box carries an RLE of its image's original
    size, through 12 tensor-core forwards."""
    import numpy as np
    from PIL import Image

    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.predict import Predictor

    predictor = Predictor.from_state_dict(weights, cfg,
                                          tokenizer=build_tokenizer(cfg))
    rng = np.random.default_rng(SEED)
    sizes = [(480, 640), (600, 800), (427, 640), (480, 600)]
    imgs = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype="uint8"))
            for h, w in sizes]
    predictor(imgs[:1], task_ids=[1])                  # warm-up
    before = read_counts()
    t0 = time.perf_counter()
    dets = predictor(imgs, task_ids=[1, 2, 1, 2])
    dt = time.perf_counter() - t0
    after = read_counts()
    ok = len(dets) == 4 and all(
        len(r["masks"]) == len(r["boxes"]) == NUM_QUERIES
        and all(m["size"] == [h, w] for m in r["masks"])
        for r, (h, w) in zip(dets, sizes))
    res = {"images": 4, "seconds": dt, "fwd_tc": after["fwd_tc"]
           - before["fwd_tc"], "ok": ok}
    log(f"[seg] Predictor with masks: {json.dumps(res)} | {smi}")
    if not ok or res["fwd_tc"] != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"Predictor with masks: {res}")
    return res


GATE_MARGIN = 0.015   # tests/test_torch_distill_gate.py's floor, AP@0.5


def phase_ablation(smi):
    """The port's distillation ablation (toist_tpu_torch.scripts.
    fixture_distill_ablation: the verb-noun teacher, the plain and the
    distilled student, 6 epochs each at the script's own fixture seed, f32
    under deterministic algorithms) in two processes at once on the card:
    their teacher, plain and distilled checkpoints must be equal bit for bit
    (the digests), and their APs finite. The margin (distilled minus plain
    AP@0.5) is printed beside the CPU gate's floor, not held to it: at this
    scale its sign is noise in the JAX package too (PERF.md §6: JAX's
    margin over fixture seeds 11-30 at 6 epochs has a mean of -0.0138 and
    clears the floor at 6 of 20)."""
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        runs = []
        for i in range(2):
            out = os.path.join(wd, f"run{i}.json")
            logf = open(os.path.join(wd, f"run{i}.log"), "w")
            runs.append((subprocess.Popen(
                [sys.executable, "-m",
                 "toist_tpu_torch.scripts.fixture_distill_ablation",
                 "--device", "cuda", "--workdir", os.path.join(wd, f"w{i}"),
                 "--out", out], stdout=logf, stderr=subprocess.STDOUT),
                out, logf))
        res = []
        for proc, out, logf in runs:
            rc = proc.wait(timeout=600)
            logf.close()
            if rc != 0:
                with open(logf.name) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(f"ablation process exit {rc}: {tail}")
            with open(out) as f:
                res.append(json.load(f))
        seconds = time.perf_counter() - t0
    first = dict(res[0], seconds=seconds,
                 digests_equal=res[0]["digests"] == res[1]["digests"],
                 clears_gate=res[0]["distill_minus_plain"] > GATE_MARGIN)
    log(f"[ablation] {json.dumps(first)}; second process "
        f"{json.dumps(res[1]['digests'])} | {smi}")
    aps = ("teacher_ap50", "plain_student_ap50", "distill_student_ap50")
    if not (first["digests_equal"]
            and all(r[k] == res[0][k] for r in res for k in aps)):
        raise AssertionError(f"ablation: two processes differ: {res}")
    log(f"[ablation] distilled {first['distill_student_ap50']:.4f} vs "
        f"plain {first['plain_student_ap50']:.4f} AP@0.5: margin "
        f"{first['distill_minus_plain']:+.4f} (the CPU gate's floor "
        f"{GATE_MARGIN}: {'cleared' if first['clears_gate'] else 'not'}"
        f" cleared) | {smi}")
    if not all(math.isfinite(first[k]) for k in aps):
        raise AssertionError(f"ablation: {first}")
    return first


# -- phase 14: data parallel through torchrun ---------------------------------

DP_B = 6              # per-rank train batch (phase 8's)
DP_PAIRS = 3          # per-rank distillation pairs (phase 12's)
DP_SEG_B = 2          # per-rank seg batch (phase 13's)
DP_TIMEOUT = 420      # seconds for one torchrun
DP_TRAIN = {"fwd": LAUNCHES_PER_FORWARD, "dkv": LAUNCHES_PER_FORWARD,
            "dq": LAUNCHES_PER_FORWARD, "fwd_tc": LAUNCHES_PER_FORWARD,
            "dkv_tc": LAUNCHES_PER_FORWARD, "dq_tc": LAUNCHES_PER_FORWARD,
            "dropout": 3 * LAUNCHES_PER_FORWARD, "lsa": 1}
DP_DISTILL = {k: 2 * v for k, v in DP_TRAIN.items()}
DP_DISTILL["lsa"] = 3
DP_EVAL = dict({k: 0 for k in DP_TRAIN}, fwd=LAUNCHES_PER_FORWARD,
               fwd_tc=LAUNCHES_PER_FORWARD, lsa=1)


def _digest(tensors):
    """One hash of the bytes of ``tensors`` in order (bit-for-bit
    comparison of replicas across ranks)."""
    import hashlib

    import torch

    h = hashlib.blake2b(digest_size=16)
    for t in tensors:
        t = t.detach().contiguous().cpu()
        if t.dtype in (torch.bfloat16, torch.bool):
            t = t.view(torch.int16 if t.dtype == torch.bfloat16
                       else torch.uint8)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def rank_worker(spec_path):
    """One rank of phase 14, started by torchrun: toist_tpu_torch.main from
    parse_args(spec["argv"]), as ``python -m toist_tpu_torch.main`` runs
    it, with hooks that time each train step (host clock with a device
    sync), count its kernel launches and each eval batch's, and time each
    gradient all-reduce (CUDA events around parallel.data.reduce_gradients),
    and the host seconds of main's parts (the replication of rank 0's
    state, the epoch, each evaluate, each checkpoint save and the ZeRO-1
    consolidation in it). Before main leaves the process group the ranks
    all-gather their records: the digests of the rank's f32 masters and
    cluster bank, its optimizer's moment bytes, the backend. Rank 0 writes
    them to spec["result"]."""
    import torch
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.ops import flash_attention as fa
    from toist_tpu_torch.parallel import data as dp
    from toist_tpu_torch.parallel import tp
    from toist_tpu_torch.train import checkpoint as ckpt
    from toist_tpu_torch.train import engine
    from toist_tpu_torch.utils import dist

    with open(spec_path) as f:
        spec = json.load(f)
    rec = {"steps": [], "eval_launches": [], "reduce_ms": [], "parts_s": {}}
    # Phase 15(c): the (heads, D) of every forward launch.
    shapes, launch_fwd = set(), fa._launch_fwd

    def shaped_fwd(q, k, v, mask_u8, num_heads, *rest):
        shapes.add((num_heads, q.shape[2]))
        return launch_fwd(q, k, v, mask_u8, num_heads, *rest)
    fa._launch_fwd = shaped_fwd

    def timed(part, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                rec["parts_s"][part] = rec["parts_s"].get(part, 0.0) + (
                    time.perf_counter() - t)
        return run
    held, events = {}, []

    def counted_train(make):
        def make_step(*args, **kwargs):
            step = make(*args, **kwargs)

            def train_step(state, batch):
                torch.cuda.synchronize()
                before = read_counts()
                tp.reset_counts()
                t0 = time.perf_counter()
                state, scalars = step(state, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                after = read_counts()
                held["state"] = state
                sv = (batch["sth"] if "sth" in batch else batch)[
                    "sample_valid"]
                rec["steps"].append({
                    "ms": ms, "images": int(sv.sum()),
                    "launches": {k: after[k] - before[k] for k in after},
                    "tp": dict(tp.COUNTS),
                    "loss": float(scalars["loss"])})
                rec["reduce_ms"] += [s.elapsed_time(e) for s, e in events]
                events.clear()
                return state, scalars
            return train_step
        return make_step

    def counted_eval(make):
        def make_step(*args, **kwargs):
            step = make(*args, **kwargs)

            def eval_step(*a):
                before = read_counts()
                res = step(*a)
                after = read_counts()
                rec["eval_launches"].append({k: after[k] - before[k]
                                             for k in after})
                return res
            return eval_step
        return make_step

    reduce = dp.reduce_gradients

    def timed_reduce(grads, scalars):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        reduce(grads, scalars)
        end.record()
        events.append((start, end))

    destroy = dist.destroy

    def gathering_destroy():
        state = held.get("state")
        rec["parts_s"]["main"] = time.perf_counter() - held["t0"]
        mine = dict(rec, rank=dist.process_index(),
                    backend=torch.distributed.get_backend(),
                    device=str(torch.cuda.current_device()))
        if "tp_batch" in spec:
            _tp_f32_forward(spec)
        mine["fwd_shapes"] = sorted(map(list, shapes))
        if state is not None:
            bank = state.cluster_bank
            mine.update(
                masters=_digest(m for _, m in state.masters),
                masters_replicated=_digest(
                    m for p, m in state.masters if not hasattr(p, "tp_spec")),
                sharded_numel=sum(p.numel() for p in
                                  state.model.parameters()
                                  if hasattr(p, "tp_spec")),
                n_masters=len(state.masters),
                bank=_digest([bank.feature_bank, bank.cluster_centers,
                              bank.update_count, bank.full])
                if bank is not None else None,
                zero1=hasattr(state.optimizer, "optim"),
                moment_bytes=dp.optimizer_state_bytes(state.optimizer))
        ranks = dist.all_gather_object(mine)
        if dist.process_index() == 0:
            with open(spec["result"], "w") as f:
                json.dump(ranks, f)
        destroy()

    for name in ("make_train_step", "make_distillation_train_step"):
        setattr(pmain, name, counted_train(getattr(pmain, name)))
    for name in ("make_eval_step", "make_cluster_eval_step"):
        setattr(pmain, name, counted_eval(getattr(pmain, name)))
    dp.reduce_gradients = timed_reduce
    dist.destroy = gathering_destroy
    dp.replicate = timed("replicate", dp.replicate)
    ckpt.save = timed("checkpoint_save", ckpt.save)
    engine.evaluate = timed("evaluate", engine.evaluate)
    engine.train_one_epoch = timed("train_one_epoch", engine.train_one_epoch)
    ZeroRedundancyOptimizer.consolidate_state_dict = timed(
        "zero1_consolidate", ZeroRedundancyOptimizer.consolidate_state_dict)
    reset_counts()
    held["t0"] = time.perf_counter()
    pmain.main(pmain.parse_args(spec["argv"]))


def _tp_f32_forward(spec):
    """A tensor-parallel rank's f32 forward of the run's checkpoint on
    spec["tp_batch"] (the kernels' f32 route on its heads); rank 0 saves
    the logits and boxes to spec["tp_logits"]."""
    import torch

    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.parallel import tp
    from toist_tpu_torch.train import checkpoint as ckpt
    from toist_tpu_torch.train.step import eval_forward
    from toist_tpu_torch.utils import dist

    torch.distributed.barrier()         # rank 0's checkpoint is written
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = pmain.parse_args(spec["argv"] + ["model.compute_dtype=float32"])
    model = TOIST.from_state_dict(ckpt.load_params(spec["checkpoint"]),
                                  cfg.model)
    tp.shard_model(model, (dist.model_index(), dist.model_count()))
    out, _ = eval_forward(model, torch.load(spec["tp_batch"],
                                            weights_only=False))
    if dist.process_index() == 0:
        torch.save({k: out[k].cpu() for k in ("pred_logits", "pred_boxes")},
                   spec["tp_logits"])


def _torchrun(nproc, target, out, timeout=DP_TIMEOUT):
    """Run ``torchrun --standalone --nproc_per_node nproc <target>`` from
    the repository root; its output goes to <out>.log. Raises unless it
    exits 0 within ``timeout``."""
    log_path = out + ".log"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", *target]
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
    seconds = time.perf_counter() - t0
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-6000:]
        raise AssertionError(f"phase 14: torchrun {nproc} {target[:3]} "
                             f"exited {rc} after {seconds:.1f} s:\n{tail}")
    return seconds


def _dp_run(root, name, nproc, argv, extra=None):
    """One torchrun of rank_worker over toist_tpu_torch.main ``argv`` (and
    ``extra`` keys of its spec); returns (the ranks' records, seconds)."""
    out = os.path.join(root, name)
    spec = dict(extra or {}, argv=["--output-dir", out] + argv,
                result=out + ".json")
    with open(out + ".spec.json", "w") as f:
        json.dump(spec, f)
    seconds = _torchrun(nproc, ["chip_smoke.py", "--rank-worker",
                                out + ".spec.json"], out)
    with open(spec["result"]) as f:
        return json.load(f), seconds


def _eval_record(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if r["kind"] == "eval"]
    return evals[-1]


def _dp_summary(ranks, want_train, want_eval, images_per_step):
    """Per run: steps, launches per step and per eval batch against the
    single-process phases', masters and bank equal across ranks, step ms,
    img/s over the ranks, all-reduce ms per step, moment bytes per rank."""
    steps = [st for r in ranks for st in r["steps"]]
    bad_train = [st["launches"] for st in steps
                 if st["launches"] != want_train]
    bad_eval = [c for r in ranks for c in r["eval_launches"]
                if c != want_eval]
    # The first step of a canvas compiles nothing here but warms cuDNN's
    # algorithm choice and the allocator: left out of the rate.
    per_rank_ms = [[st["ms"] for st in r["steps"]] for r in ranks]
    step_ms = [statistics.median(ms[1:] or ms) for ms in per_rank_ms]
    reduce_ms = [x for r in ranks for x in r["reduce_ms"][1:]]
    return {
        "ranks": len(ranks), "backend": ranks[0]["backend"],
        "steps_per_rank": [len(r["steps"]) for r in ranks],
        "images_per_rank": [sum(st["images"] for st in r["steps"])
                            for r in ranks],
        "bad_train_launches": bad_train[:3],
        "bad_eval_launches": bad_eval[:3],
        "train_launches_per_step": steps[0]["launches"] if steps else None,
        "eval_batches": sum(len(r["eval_launches"]) for r in ranks),
        "masters_equal": len({r["masters"] for r in ranks}) == 1,
        "bank_equal": len({r.get("bank") for r in ranks}) == 1,
        "has_bank": ranks[0].get("bank") is not None,
        "zero1": [r["zero1"] for r in ranks],
        "moment_bytes_per_rank": [r["moment_bytes"] for r in ranks],
        "step_ms_median": max(step_ms),
        "img_s": images_per_step * 1e3 / max(step_ms),
        "allreduce_ms_median": (statistics.median(reduce_ms)
                                if reduce_ms else "not measured"),
        "allreduce_ms_max": max(reduce_ms) if reduce_ms else "not measured",
        "step_ms_all": per_rank_ms,
        "losses": [[round(st["loss"], 6) for st in r["steps"]]
                   for r in ranks]}


def phase_dp(smi, root):
    """Phase 14: data parallelism through torchrun at full width (the
    flagship ModelConfig, bf16 with f32 masters, dropout 0.1, the seeded
    weights by --load) on the fixture.

    (a) One rank on NCCL: ``torchrun --standalone --nproc_per_node 1``
    over rank_worker, one epoch of plain detection at batch 6 with
    run.shard_opt_state on (ZeRO-1 applies from 2 ranks), checkpoint and
    eval; then ``torchrun --standalone --nproc_per_node 1 -m
    toist_tpu_torch.main --eval --resume`` of its checkpoint, whose eval
    must equal the in-run one. (b) Two ranks sharing the card (gloo: NCCL
    refuses two ranks on one device) on a fixture of 12 images per split:
    plain detection (per-rank batch 6, ZeRO-1), distillation (3 pairs per
    rank, the bank [14, 1024, 256]) and segmentation (per-rank batch 2,
    frozen detector, from (b)'s plain checkpoint), each one epoch with its
    eval. Every rank's train steps launch what phases 8, 12 and 13 count
    per step, every eval batch what phase 11's does; the ranks' f32
    masters and banks are equal bit for bit (all-gathered digests); each
    merged eval equals a one-process ``--eval --resume`` of the run's
    checkpoint in this process; the ZeRO-1 moments per rank are about half
    of (a)'s."""
    import torch

    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.fixtures import generate_fixture

    t_phase = time.perf_counter()
    res = {}
    key = "transformer.text_encoder.embeddings.word_embeddings.weight"
    sd = seeded_weights(SEED)

    def fixture(name, per_split):
        data = os.path.join(root, name)
        generate_fixture(data, num_tasks=2, imgs_per_split=per_split,
                         seed=SEED)
        sets = [f"data.coco_path={data}",
                f"data.refexp_ann_path={os.path.join(data, 'annotations')}",
                "data.tasks=[1,2]", "data.num_workers=4", "optim.epochs=1",
                "optim.eval_skip=1", "run.shard_opt_state=true"]
        vocab = build_tokenizer(pmain.parse_args(["--set", *sets])
                                ).vocab_size
        load = os.path.join(root, f"{name}_weights.pth")
        torch.save({"model": dict(sd, **{key: sd[key][:vocab]})}, load)
        return sets, load

    big, big_load = fixture("dp_data", 30)
    plain_a = big + [f"optim.train_batch_size={DP_B}",
                     f"optim.valid_batch_size={B}"]
    ranks_a, secs_a = _dp_run(root, "dp_a", 1,
                              ["--load", big_load, "--set", *plain_a])
    out_a = os.path.join(root, "dp_a")
    secs_a2 = _torchrun(1, ["-m", "toist_tpu_torch.main", "--eval",
                            "--resume", os.path.join(out_a, "checkpoint"),
                            "--output-dir", out_a + "_eval", "--set",
                            *plain_a], out_a + "_eval")
    res["a"] = dict(_dp_summary(ranks_a, DP_TRAIN, DP_EVAL, DP_B),
                    seconds=secs_a, eval_seconds=secs_a2,
                    parts_s=ranks_a[0]["parts_s"],
                    eval_equal=_eval_record(out_a)["per_task"]
                    == _eval_record(out_a + "_eval")["per_task"])
    log(f"[dp] (a) 1 rank: {json.dumps(res['a'])} | {smi}")

    small, small_load = fixture("dp_small", 12)
    runs = {
        "plain": (small + [f"optim.train_batch_size={DP_B}",
                           f"optim.valid_batch_size={B}"],
                  ["--load", small_load], DP_TRAIN, DP_B),
        "distill": (small + [f"optim.train_batch_size={DP_PAIRS}",
                             "optim.valid_batch_size=1",
                             f"run.load_noun={small_load}", *DISTILL_SETS],
                    ["--load", small_load], DP_DISTILL, DP_PAIRS),
        "seg": (small + [f"optim.train_batch_size={DP_SEG_B}",
                         f"optim.valid_batch_size={SEG_EVAL_B}",
                         *SEG_SETS],
                None, SEG_TRAIN_LAUNCHES, DP_SEG_B)}
    res["b"] = {}
    for name, (sets, load, want, per_rank) in runs.items():
        if load is None:     # seg: (b)'s plain detection checkpoint
            load = ["--load", os.path.join(root, "dp_b_plain", "checkpoint")]
        out = os.path.join(root, f"dp_b_{name}")
        ranks, secs = _dp_run(root, f"dp_b_{name}", 2,
                              load + ["--set", *sets])
        want_eval = SEG_EVAL_LAUNCHES if name == "seg" else DP_EVAL
        summary = _dp_summary(ranks, want, want_eval, 2 * per_rank)
        # The merged eval against one process's eval of the checkpoint.
        t_one = time.perf_counter()
        pmain.main(pmain.parse_args(
            ["--eval", "--resume", os.path.join(out, "checkpoint"),
             "--output-dir", out + "_one", "--set", *sets]))
        torch.cuda.empty_cache()
        summary.update(seconds=secs,
                       one_process_eval_s=time.perf_counter() - t_one,
                       parts_s=[r["parts_s"] for r in ranks],
                       eval_equal=_eval_record(out)[
            "per_task"] == _eval_record(out + "_one")["per_task"],
            mean_ap50=_eval_record(out)["mean_ap50"])
        res["b"][name] = summary
        log(f"[dp] (b) 2 ranks, {name}: {json.dumps(summary)} | {smi}")
    a_bytes = res["a"]["moment_bytes_per_rank"][0]
    plain_b = res["b"]["plain"]
    res["zero1_share"] = [b / a_bytes for b in
                          plain_b["moment_bytes_per_rank"]]
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[dp] moments per rank: (a) 1 rank {a_bytes / 2**30:.3f} GiB; (b) "
        f"2 ranks ZeRO-1 {[round(b / 2**30, 3) for b in plain_b['moment_bytes_per_rank']]} "
        f"GiB, shares {[round(s, 4) for s in res['zero1_share']]} of (a); "
        f"step ms (a) {res['a']['step_ms_median']:.1f}, (b) "
        f"{plain_b['step_ms_median']:.1f}; all-reduce ms per step (a) NCCL "
        f"{res['a']['allreduce_ms_median']}, (b) gloo "
        f"{plain_b['allreduce_ms_median']}; phase {res['seconds']:.1f} s "
        f"| {smi}")
    bad = []
    for label, s in [("a", res["a"])] + [(f"b {k}", v)
                                         for k, v in res["b"].items()]:
        if (s["bad_train_launches"] or s["bad_eval_launches"]
                or not s["masters_equal"] or not s["bank_equal"]
                or not s["eval_equal"] or not s["eval_batches"]
                or min(s["steps_per_rank"]) < 1
                or len(set(s["steps_per_rank"])) != 1):
            bad.append(label)
    want_backend = [res["a"]["backend"]] + [
        v["backend"] for v in res["b"].values()]
    if (bad or want_backend != ["nccl", "gloo", "gloo", "gloo"]
            or res["a"]["zero1"] != [False]
            or any(v["zero1"] != [True, True] for v in res["b"].values())
            or not res["b"]["distill"]["has_bank"]
            or not all(0.35 < s < 0.65 for s in res["zero1_share"])):
        raise AssertionError(f"phase 14 (data parallel): {json.dumps(res)}; "
                             f"failed: {bad}")
    return res


# -- phase 15: EfficientNet-B3 with pretrained files, remat, tensor parallel --

EFFNET = "timm_tf_efficientnet_b3_ns"   # MDETR's published B3 backbone
REMAT_TRAIN = dict(DP_TRAIN, fwd=18, fwd_tc=18, dropout=18 + 24)
TP_SETS = ["run.mesh_shape=[-1,2]", 'run.mesh_axes=["data","model"]']
VIS_MAX = 20


class _Tee:
    """A stream that writes to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.kept = out, []

    def write(self, text):
        self.kept.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _upstream_files(root, cfg, vocab):
    """A timm EfficientNet-B3 and a Hugging Face roberta-base state dict,
    random from a seed in their own layouts (timm's head, HF's
    position_ids and pooler beside the model's tensors; the word
    embeddings cut to the fixture tokenizer's vocabulary, as phase 11's
    --load), written as .pth files. Returns (paths, state dicts)."""
    import torch

    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.utils.pretrained import BACKBONE, TEXT

    with torch.device("meta"):
        model = TOIST(cfg.model, text_vocab_size=vocab)
    g = torch.Generator().manual_seed(SEED + 15)
    files = {}
    for prefix, name in ((BACKBONE, "tf_efficientnet_b3_ns.pth"),
                         (TEXT, "roberta-base.bin")):
        sd = {}
        for k, v in model.state_dict().items():
            if not k.startswith(prefix):
                continue
            k = k[len(prefix):]
            if k.endswith("running_var"):
                t = torch.rand(v.shape, generator=g) + 0.5
            elif k.endswith("running_mean") or k.endswith("bias"):
                t = torch.randn(v.shape, generator=g) * 0.02
            elif "LayerNorm" in k or v.dim() == 1:
                t = 1.0 + torch.randn(v.shape, generator=g) * 0.02
            elif v.dim() == 4:          # conv: std 1 / sqrt(fan_in)
                t = torch.randn(v.shape, generator=g) / v[0].numel() ** 0.5
            else:
                t = torch.randn(v.shape, generator=g) * 0.02
            sd[k] = t
        if prefix == BACKBONE:
            sd.update({"conv_head.weight": torch.zeros(1536, 384, 1, 1),
                       "bn2.weight": torch.ones(1536),
                       "classifier.weight": torch.zeros(1000, 1536)})
        else:
            sd["embeddings.position_ids"] = torch.arange(514)[None]
            sd["pooler.dense.weight"] = torch.zeros(768, 768)
        path = os.path.join(root, name)
        torch.save(sd, path)
        files[prefix] = (path, sd)
    return files


def _f32_kernel_vs_plain(label, model, batch):
    """One eval batch in f32 through the kernels and through the plain
    attention: pred_logits and pred_boxes within SLICE_TOL."""
    import torch

    from toist_tpu_torch.models.layers import set_fused_attention
    from toist_tpu_torch.train.step import eval_forward

    reset_counts()
    out_k, _ = eval_forward(model, batch)
    launches = read_counts()
    set_fused_attention(model, False)
    out_p, _ = eval_forward(model, batch)
    set_fused_attention(model, True)
    errs = {}
    for key in ("pred_logits", "pred_boxes"):
        a, b = out_k[key], out_p[key]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{label}: {key} not finite")
        errs[key] = (a - b).abs().max().item()
    log(f"[{label}] f32 eval batch, kernel vs plain max abs err "
        f"{json.dumps(errs)} (tolerance {SLICE_TOL}), launches "
        f"{json.dumps(launches)}")
    if max(errs.values()) > SLICE_TOL or launches["fwd"] != \
            LAUNCHES_PER_FORWARD or launches["fwd_tc"]:
        raise AssertionError(f"{label} f32 kernel vs plain: {errs}, "
                             f"{launches}")
    return errs


def phase_effnet(smi, root, phase8):
    """Phase 15(a): toist_tpu_torch.main with model.backbone
    timm_tf_efficientnet_b3_ns, fresh, with run.pretrained_backbone (timm
    B3) and run.pretrained_text (HF roberta-base), run.profile_dir (which
    traces the first epoch), two epochs of batch 6, each with the eval at
    batch 8 (the second epoch's steps, untraced, give the step ms); then
    Predictor.from_checkpoint of its checkpoint on 8 images and visualize
    of the checkpoint."""
    import contextlib

    import numpy as np
    import torch
    from PIL import Image

    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.data.batcher import BatchIterator
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.cocotasks import build_task_dataset
    from toist_tpu_torch.data.fixtures import generate_fixture
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.predict import Predictor
    from toist_tpu_torch.train import checkpoint as ckpt
    from toist_tpu_torch.train import engine
    from toist_tpu_torch.train.state import model_masters
    from toist_tpu_torch.utils.pretrained import BACKBONE, TEXT
    from toist_tpu_torch.visualize import visualize

    t_phase = time.perf_counter()
    data = os.path.join(root, "effnet_data")
    generate_fixture(data, num_tasks=2, imgs_per_split=12, seed=SEED)
    out, prof = (os.path.join(root, n) for n in ("effnet_out",
                                                  "effnet_profile"))
    sets = [f"data.coco_path={data}",
            f"data.refexp_ann_path={os.path.join(data, 'annotations')}",
            "data.tasks=[1,2]", "data.num_workers=4", "optim.epochs=2",
            f"optim.train_batch_size={TRAIN_B}",
            f"optim.valid_batch_size={B}", "optim.eval_skip=1",
            f"model.backbone={EFFNET}"]
    cfg0 = pmain.parse_args(["--set", *sets])
    vocab = build_tokenizer(cfg0).vocab_size
    files = _upstream_files(root, cfg0, vocab)
    sets += [f"run.pretrained_backbone={files[BACKBONE][0]}",
             f"run.pretrained_text={files[TEXT][0]}",
             f"run.profile_dir={prof}"]
    argv = ["--output-dir", out, "--set", *sets]
    cfg = pmain.parse_args(argv)

    hooks = _Hooks()
    landed, steps, epoch = {}, [], [None]
    make, one_epoch = pmain.make_train_step, engine.train_one_epoch

    def tagged(step, state, it, n, **kwargs):
        epoch[0] = n
        return one_epoch(step, state, it, n, **kwargs)

    def checked(*args, **kwargs):
        step = make(*args, **kwargs)

        def train_step(state, batch):
            if not landed:        # before the first step: the files' tensors
                masters = {n: m for n, _, m in model_masters(state)}
                own = state.model.state_dict()
                bad = []
                for prefix, (_, sd) in files.items():
                    for k, v in sd.items():
                        n = prefix + k
                        if n in masters:
                            ok = torch.equal(masters[n].cpu(), v)
                        elif n in own:    # frozen BN, in the compute dtype
                            ok = torch.equal(own[n].cpu(), v.to(
                                own[n].dtype))
                        else:
                            continue
                        landed[n] = ok
                        if not ok:
                            bad.append(n)
                landed["_bad"] = bad
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, scalars = step(state, batch)
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "epoch": epoch[0],
                          "canvas": list(batch["images"].shape[1:3]),
                          "images": int(batch["sample_valid"].sum()),
                          "loss": float(scalars["loss"])})
            return state, scalars
        return train_step

    pmain.make_train_step, engine.train_one_epoch = checked, tagged
    tee = _Tee(sys.stdout)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            best = pmain.main(cfg)
        main_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = read_counts()
    finally:
        pmain.make_train_step, engine.train_one_epoch = make, one_epoch
        hooks.undo()
    printed = [ln for ln in "".join(tee.kept).splitlines()
               if ln.startswith("[profile] ")]
    traces = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
    trace_mib = [os.path.getsize(os.path.join(prof, t)) / 2 ** 20
                 for t in traces]
    want_eval = dict({k: 0 for k in DP_TRAIN}, fwd=LAUNCHES_PER_FORWARD,
                     fwd_tc=LAUNCHES_PER_FORWARD, lsa=1)
    bad_train = [c for c in hooks.train if c != DP_TRAIN]
    bad_eval = [c for run in hooks.evals for c in run["launches"]
                if c != want_eval]
    n_landed = sum(1 for k, v in landed.items() if k != "_bad")

    # Predictor.from_checkpoint: a batch of 8 fixture images.
    ck = os.path.join(out, "checkpoint")
    predictor = Predictor.from_checkpoint(ck, cfg)
    ds = build_task_dataset(cfg.data, 1, "val", predictor.tokenizer)
    imgs = [Image.open(os.path.join(ds.img_dir, ds.coco.imgs[i][
        "file_name"])).convert("RGB") for i in sorted(ds.coco.imgs)[:B]]
    before = read_counts()
    t0 = time.perf_counter()
    dets = predictor(imgs, task_ids=[1] * len(imgs))
    predict_s = time.perf_counter() - t0
    pred_fwd = read_counts()["fwd_tc"] - before["fwd_tc"]
    _check_results(dets, len(imgs), cfg.model.num_queries)

    # visualize of the checkpoint.
    vis = os.path.join(root, "effnet_vis")
    n_images = sum(len(build_task_dataset(cfg.data, t, "val",
                                          predictor.tokenizer))
                   for t in cfg.data.tasks)
    vcfg = pmain.parse_args(argv + [f"run.resume={ck}"])
    t0 = time.perf_counter()
    n_vis = visualize(vcfg, vis, max_images=VIS_MAX)
    vis_s = time.perf_counter() - t0
    pngs = [f for f in os.listdir(vis) if f.endswith(".png")]

    # One f32 eval batch through the kernels against the plain attention.
    del predictor
    torch.cuda.empty_cache()
    f32 = pmain.parse_args(argv + ["model.compute_dtype=float32"])
    model = TOIST.from_state_dict(ckpt.load_params(ck), f32.model)
    batch = next(BatchIterator([ds], pmain.build_specs(f32)[1],
                               batch_size=B, shuffle=False).epoch(0))
    f32_errs = _f32_kernel_vs_plain("effnet-f32", model, batch)
    del model
    torch.cuda.empty_cache()

    # The second epoch's steps: warm (each canvas seen) and untraced.
    second = [st for st in steps if st["epoch"] == 1]
    ms = [st["ms"] for st in second]
    p8 = [st["ms"] for st in phase8["steps"][1:]]
    res = {"backbone": EFFNET, "train_steps": len(steps),
           "steps": steps, "step_ms_median": statistics.median(ms),
           "phase8_step_ms_median": statistics.median(p8),
           "step_ms_ratio_to_phase8": statistics.median(ms)
           / statistics.median(p8),
           "img_s": sum(st["images"] for st in second) / (sum(ms) / 1e3),
           "traced_step_ms_median": statistics.median(
               st["ms"] for st in steps if st["epoch"] == 0),
           "peak_gib": peak, "phase8_peak_gib": phase8["peak_gib"],
           "pretrained_tensors_landed": n_landed,
           "pretrained_bad": landed.get("_bad", ["no step"])[:5],
           "launches": launches,
           "train_launches_per_step": hooks.train[0] if hooks.train
           else None, "eval_batches": sum(len(r["launches"])
                                          for r in hooks.evals),
           "mean_ap50": best, "main_s": main_s, "profile_lines": printed,
           "traces": traces, "trace_mib": trace_mib,
           "predictor": {"images": len(imgs), "forwards_tc": pred_fwd,
                         "seconds": predict_s},
           "visualize": {"written": n_vis, "pngs": len(pngs),
                         "val_images": n_images, "seconds": vis_s},
           "f32_kernel_vs_plain": f32_errs,
           "seconds": time.perf_counter() - t_phase}
    log(f"[effnet] {json.dumps(res)} | {smi}")
    log(f"[effnet] B3 step {res['step_ms_median']:.1f} ms median over the "
        f"untraced epoch ({res['traced_step_ms_median']:.1f} traced; phase 8, "
        f"ResNet-101: {res['phase8_step_ms_median']:.1f} ms; ratio "
        f"{res['step_ms_ratio_to_phase8']:.3f}), {res['img_s']:.2f} img/s, "
        f"peak {peak:.2f} GiB (phase 8: {phase8['peak_gib']:.2f}) | {smi}")
    if (bad_train or bad_eval or len(second) < 2 or len(hooks.evals) != 2
            or landed.get("_bad", ["no step"]) or n_landed < 100
            or not np.isfinite(best) or len(printed) != 1
            or len(traces) != 1 or n_vis != min(VIS_MAX, n_images)
            or len(pngs) != n_vis or pred_fwd % LAUNCHES_PER_FORWARD
            or not pred_fwd):
        raise AssertionError(f"phase 15(a) (EfficientNet-B3): "
                             f"{json.dumps(res)}; bad train "
                             f"{bad_train[:3]}, bad eval {bad_eval[:3]}")
    return res


def phase_remat(smi, state_dict, root, phase8):
    """Phase 15(b): model.remat on the flagship (ResNet-101) at batch 6 on
    832x1344: bf16 steps with and without remat on the same batches (step
    ms, peak memory, launches), and one f32 step at rate 0.1 with remat
    against one without on the same generator."""
    import dataclasses

    import torch

    from toist_tpu_torch.data.batcher import BatchIterator, BucketSpec, \
        train_buckets
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.cocotasks import build_task_dataset
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.parallel import data as dp
    from toist_tpu_torch.train.criterion import build_weight_dict
    from toist_tpu_torch.train.state import init_train_state
    from toist_tpu_torch.train.step import (TRAIN_KEYS, accumulate_gradients,
                                            batch_to_device, make_train_step)

    t_phase = time.perf_counter()
    cfg = _fixture_config(os.path.join(root, "remat_data"))
    d = cfg.data
    tok = build_tokenizer(cfg)
    spec = BucketSpec(buckets=train_buckets(d.max_size, d.train_scales),
                      max_text_len=d.max_text_len, max_boxes=d.max_boxes,
                      num_logit_cols=d.num_logit_cols)
    it = BatchIterator([build_task_dataset(d, t, "train", tok)
                        for t in d.tasks], spec, batch_size=TRAIN_B,
                       seed=cfg.run.seed, num_workers=1)
    top = (832, 1344)
    batches = [b for b in it.epoch(0, num_workers=1)
               if tuple(b["images"].shape[1:3]) == top]
    while len(batches) < 4:
        batches += batches
    batches = batches[:4]
    wd = build_weight_dict(cfg.loss, False, cfg.model.dec_layers)
    runs = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat=remat))
        model = TOIST.from_state_dict(state_dict, c.model)
        state = init_train_state(model, c, 10, 100)
        step = make_train_step(c, wd)
        state, _ = step(state, batches[0])          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, counts = [], []
        for b in batches[1:]:
            before = read_counts()
            t0 = time.perf_counter()
            state, sc = step(state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            after = read_counts()
            counts.append({k: after[k] - before[k] for k in after})
        # What stays between steps, which remat does not touch: the f32
        # masters, AdamW's moments, the bf16 parameters, all allocations.
        state_bytes = {
            "master_bytes": sum(m.numel() * m.element_size()
                                for p, m in state.masters if m is not p),
            "moment_bytes": dp.optimizer_state_bytes(state.optimizer),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
            "resident_bytes": torch.cuda.memory_allocated()}
        peak = torch.cuda.max_memory_allocated()
        runs[remat] = {"step_ms": ms, "launches": counts,
                       "peak_gib": peak / 2**30, **state_bytes,
                       "transient_gib": (peak - state_bytes["resident_bytes"])
                       / 2**30, "loss": float(sc["loss"])}
        del model, state, step
        torch.cuda.empty_cache()

    # f32, rate 0.1: remat against no remat, one step's losses and grads.
    f32 = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat=remat, compute_dtype="float32"))
        model = TOIST.from_state_dict(state_dict, c.model)
        state = init_train_state(model, c, 10, 100)
        x = batch_to_device(batches[1], "cuda", TRAIN_KEYS)
        sc = accumulate_gradients(state, x, c, wd)
        names = {id(p): n for n, p in model.named_parameters()}
        f32[remat] = ({k: float(v) for k, v in sc.items() if v.dim() == 0},
                      {names[id(p)]: m.grad.detach().clone()
                       for p, m in state.masters})
        del model, state
        torch.cuda.empty_cache()
    (lr, gr), (ln, gn) = f32[True], f32[False]
    loss_err = max(abs(lr[k] - ln[k]) / max(abs(ln[k]), 1e-6) for k in ln)
    top_g = max(g.abs().max().item() for g in gn.values())
    grad_errs = []
    for n, g in gn.items():
        scale = g.abs().max().item()
        err = (gr[n] - g).abs().max().item()
        # Tensors whose gradient is rounding noise (0 by construction) are
        # held to 1e-4 of the largest gradient instead of to their own.
        grad_errs.append((err / scale if scale > 1e-4 * top_g
                          else err / top_g * STEP_GRAD_TOL / 1e-4, n))
    grad_errs.sort()
    res = {"batch": TRAIN_B, "canvas": list(top),
           "remat": runs[True], "no_remat": runs[False],
           "step_ms_ratio": statistics.median(runs[True]["step_ms"])
           / statistics.median(runs[False]["step_ms"]),
           "peak_ratio": runs[True]["peak_gib"] / runs[False]["peak_gib"],
           "phase8_peak_gib": phase8["peak_gib"],
           "phase8_step_ms_832x1344": sorted(
               st["ms"] for st in phase8["steps"]
               if tuple(st["canvas"]) == top),
           "f32_rate_0.1": {"loss_max_rel_err": loss_err,
                            "grad_max_rel_err": grad_errs[-1][0],
                            "worst_grads": grad_errs[-3:],
                            "losses": {"remat": lr["loss"],
                                       "no_remat": ln["loss"]}},
           "seconds": time.perf_counter() - t_phase}
    log(f"[remat] {json.dumps(res)} | {smi}")
    log(f"[remat] step ms median {statistics.median(runs[True]['step_ms']):.1f}"
        f" with remat, {statistics.median(runs[False]['step_ms']):.1f} "
        f"without (ratio {res['step_ms_ratio']:.3f}); peak "
        f"{runs[True]['peak_gib']:.2f} GiB with, "
        f"{runs[False]['peak_gib']:.2f} without (ratio "
        f"{res['peak_ratio']:.3f}); phase 8's peak {phase8['peak_gib']:.2f} "
        f"GiB | {smi}")
    log("[remat] between steps (GiB, with / without remat): " + ", ".join(
        f"{k} {runs[True][k] / 2**30:.3f} / {runs[False][k] / 2**30:.3f}"
        for k in ("master_bytes", "moment_bytes", "param_bytes",
                  "resident_bytes")) + "; above that at the peak "
        f"{runs[True]['transient_gib']:.3f} / "
        f"{runs[False]['transient_gib']:.3f} | {smi}")
    bad = [c for c in runs[True]["launches"] if c != REMAT_TRAIN] + [
        c for c in runs[False]["launches"] if c != DP_TRAIN]
    if (bad or loss_err > LOSS_RTOL or grad_errs[-1][0] > STEP_GRAD_TOL
            or not res["peak_ratio"] < 1.0):
        raise AssertionError(f"phase 15(b) (remat): {json.dumps(res)}; bad "
                             f"launches {bad[:3]}")
    return res


def phase_tp(smi, root):
    """Phase 15(c): tensor parallelism through torchrun, 2 ranks sharing
    the card on gloo as a (1, 2) ('data', 'model') grid: plain detection at
    batch 6 per data group, one epoch on phase 14's 2 x 12 fixture, then
    the eval; then the consolidated checkpoint in this one process on an
    f32 batch against the TP ranks' f32 forward of the same weights."""
    import torch

    from toist_tpu_torch import main as pmain
    from toist_tpu_torch.data.batcher import BatchIterator
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.cocotasks import build_task_dataset
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.train import checkpoint as ckpt
    from toist_tpu_torch.train.step import eval_forward

    t_phase = time.perf_counter()
    data = os.path.join(root, "dp_small")           # phase 14's fixture
    sets = [f"data.coco_path={data}",
            f"data.refexp_ann_path={os.path.join(data, 'annotations')}",
            "data.tasks=[1,2]", "data.num_workers=4", "optim.epochs=1",
            "optim.eval_skip=1", "run.shard_opt_state=true",
            f"optim.train_batch_size={DP_B}", f"optim.valid_batch_size={B}",
            *TP_SETS]
    cfg = pmain.parse_args(["--set", *sets])
    ds = build_task_dataset(cfg.data, 1, "val", build_tokenizer(cfg))
    f32_batch = next(BatchIterator([ds], pmain.build_specs(cfg)[1],
                                   batch_size=B, shuffle=False).epoch(0))
    batch_path = os.path.join(root, "tp_batch.pt")
    torch.save(f32_batch, batch_path)
    out = os.path.join(root, "tp")
    ranks, secs = _dp_run(root, "tp", 2, [
        "--load", os.path.join(root, "dp_small_weights.pth"), "--set",
        *sets], extra={"tp_batch": batch_path,
                       "tp_logits": out + "_logits.pt",
                       "checkpoint": os.path.join(out, "checkpoint")})
    summary = _dp_summary(ranks, DP_TRAIN, DP_EVAL, DP_B)
    got = torch.load(out + "_logits.pt")
    f32 = pmain.parse_args(["--set", *sets, "model.compute_dtype=float32",
                            "run.mesh_shape=[-1]", 'run.mesh_axes=["data"]'])
    model = TOIST.from_state_dict(ckpt.load_params(
        os.path.join(out, "checkpoint")), f32.model)
    want, _ = eval_forward(model, f32_batch)
    errs = {k: (got[k].cuda() - want[k]).abs().max().item()
            for k in ("pred_logits", "pred_boxes")}
    del model
    torch.cuda.empty_cache()
    ar = [st["tp"] for r in ranks for st in r["steps"]]
    res = dict(summary, seconds=secs, parts_s=[r["parts_s"] for r in ranks],
               fwd_shapes=[r["fwd_shapes"] for r in ranks],
               replicated_equal=len({r["masters_replicated"]
                                     for r in ranks}) == 1,
               sharded_elements_per_rank=[r["sharded_numel"] for r in ranks],
               model_allreduce_per_step=ar[0] if ar else None,
               tp_vs_one_process_f32=errs,
               seconds_phase=time.perf_counter() - t_phase)
    log(f"[tp] (1, 2) grid on gloo: {json.dumps(res)} | {smi}")
    log(f"[tp] step ms {summary['step_ms_median']:.1f}; model-group "
        f"all-reduces per step {json.dumps(res['model_allreduce_per_step'])};"
        f" moments per rank "
        f"{[round(b / 2**30, 3) for b in summary['moment_bytes_per_rank']]} "
        f"GiB; f32 TP vs one process {json.dumps(errs)} | {smi}")
    if (summary["bad_train_launches"] or summary["bad_eval_launches"]
            or not summary["eval_batches"] or not res["replicated_equal"]
            or min(summary["steps_per_rank"]) < 1
            or len(set(summary["steps_per_rank"])) != 1
            or any(s != [[4, 128]] for s in res["fwd_shapes"])
            or max(errs.values()) > SLICE_TOL
            or summary["backend"] != "gloo"):
        raise AssertionError(f"phase 15(c) (tensor parallel): "
                             f"{json.dumps(res)}")
    return res


# -- phase 16: the parity runner at full width --------------------------------

PARITY_CONFIGS = ("dete_task1", "dete_all14", "seg", "noun", "distill")


def parity_worker(argv):
    """One workload of phase 16, in the process run_parity starts for it:
    toist_tpu_torch.main from its command line, as ``python -m
    toist_tpu_torch.main`` runs it, with hooks that count each train
    step's and each eval batch's kernel launches; the counts go to
    launches.json beside the run's log.jsonl."""
    from toist_tpu_torch import main as pmain

    rec = {"train": [], "eval": []}

    def counted(kind, make):
        def make_step(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(*a):
                before = read_counts()
                res = step(*a)
                after = read_counts()
                rec[kind].append({k: after[k] - before[k] for k in after})
                return res
            return run
        return make_step

    for kind, names in (("train", ("make_train_step",
                                   "make_distillation_train_step")),
                        ("eval", ("make_eval_step",
                                  "make_cluster_eval_step"))):
        for name in names:
            setattr(pmain, name, counted(kind, getattr(pmain, name)))
    args = pmain._parser().parse_args(argv)
    pmain.main(pmain._config(args), device=args.device)
    with open(os.path.join(args.output_dir, "launches.json"), "w") as f:
        json.dump(rec, f)


def phase_parity(smi):
    """Phase 16: the port's parity runner (toist_tpu_torch.scripts.
    run_parity --fixture) with the flagship model and the published
    canvases on its fixture data: synthetic reference .pth files at
    those widths, audited, then the five BASELINE configs, each in its own
    process (chip_smoke.py --parity-worker, which counts launches). Every
    config exits 0 with finite APs; every eval batch launches 12
    tensor-core forwards and 1 LSA, every distillation step phase 12's
    24 / 24 / 24 / 3."""
    from toist_tpu_torch.config import Config
    from toist_tpu_torch.scripts import run_parity as rp

    # Every setting the fixture run cuts, back at the flagship's value.
    default = Config.from_sources(None, {}).to_dict()
    extra = []
    for key in {**rp.FIXTURE_MODEL, **rp.FIXTURE_DATA}:
        sec, name = key.split(".")
        if key != "data.tasks":
            extra.append(f"{key}={json.dumps(default[sec][name])}")
    command = rp.workload_command
    me = os.path.abspath(__file__)
    rp.workload_command = lambda argv, out_dir, device: [
        sys.executable, me, "--parity-worker",
        *command(argv, out_dir, device)[3:]]
    try:
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            report = rp.main(["--fixture", "--out", out, "--device", "cuda",
                              "--extra-set", *extra])
            seconds = time.perf_counter() - t0
            launches = {}
            for name in PARITY_CONFIGS:
                with open(os.path.join(out, name, "launches.json")) as f:
                    launches[name] = json.load(f)
    finally:
        rp.workload_command = command
    res = {"seconds": seconds, "configs": {}}
    bad = []
    for name in PARITY_CONFIGS:
        r = report["results"][name]
        rec = launches[name]
        res["configs"][name] = dict(r, eval_batches=len(rec["eval"]),
                                    train_steps=len(rec["train"]),
                                    eval_launches=rec["eval"][:1],
                                    train_launches=rec["train"][:1])
        aps = list(r["per_task_ap50"].values()) + list(
            r.get("per_task_ap50_segm", {}).values())
        if not aps or not all(math.isfinite(a) for a in aps):
            bad.append((name, "AP", aps))
        if not rec["eval"] or any(c != DP_EVAL for c in rec["eval"]):
            bad.append((name, "eval launches", rec["eval"]))
        if (name == "distill") != bool(rec["train"]) or any(
                c != DP_DISTILL for c in rec["train"]):
            bad.append((name, "train launches", rec["train"]))
        log(f"[parity] {name}: AP@0.5 {json.dumps(r['per_task_ap50'])}"
            + (f" segm {json.dumps(r['per_task_ap50_segm'])}"
               if "per_task_ap50_segm" in r else "")
            + f"; {r['seconds']:.1f} s; {len(rec['eval'])} eval batches "
            f"{json.dumps(rec['eval'][:1])}; {len(rec['train'])} train "
            f"steps {json.dumps(rec['train'][:1])} | {smi}")
    log(f"[parity] run_parity --fixture at full width: {seconds:.1f} s")
    if bad:
        raise AssertionError(f"phase 16 (parity): {bad}")
    res["kernel_launches"] = {k: sum(c[k] for name in PARITY_CONFIGS
                                     for kind in ("train", "eval")
                                     for c in launches[name][kind])
                              for k in DP_EVAL}
    return res


def main() -> int:
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.getcwd())
    if sys.argv[1:2] == ["--rank-worker"]:       # phase 14's ranks
        rank_worker(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--parity-worker"]:     # phase 16's workloads
        parity_worker(sys.argv[2:])
        return 0
    import torch

    from toist_tpu_torch.train import checkpoint as ckpt

    smi, has_pil = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s, ptxas = phase_build()
    cases = phase_kernel_vs_plain()
    state_dict, batch, launches = phase_slice(smi, has_pil)
    phase_slice_kernel_vs_plain(state_dict, batch)
    attn = phase_attention_backward()
    lsa_cases, lsa_inputs = phase_lsa()
    with tempfile.TemporaryDirectory() as root:
        train, train_batch = phase_train(smi, state_dict, root)
        torch.cuda.empty_cache()
        train_f32, real = phase_train_kernel_vs_plain(state_dict,
                                                      train_batch)
    lsa_cases.append(lsa_case("real_matcher", *real, "total", lsa_inputs))
    times = phase_times(smi, lsa_cases, lsa_inputs)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        main_run = phase_main(smi, state_dict, root)
        torch.cuda.empty_cache()
        distill, dstate, dbatch, softkd = phase_distill(
            smi, root, os.path.join(root, "main_out", "checkpoint"))
        student_sd = ckpt.load_params(os.path.join(root,
                                                   "seeded_weights.pth"))
        torch.cuda.empty_cache()
        seg = phase_seg(smi, root, os.path.join(root, "main_out",
                                                "checkpoint"),
                        os.path.join(root, "distill_out", "checkpoint"))
    torch.cuda.empty_cache()
    # The f32 comparison takes seeded weights, the student's of phase 11 and
    # a teacher from the next seed (what main builds without
    # run.load_noun), and run 1's bank: after one epoch at the reference's
    # loss weights, the contrastive heads' gradients of run 1's weights are
    # sums that nearly cancel, so f32 rounding alone moves them by
    # percents.
    key = "transformer.text_encoder.embeddings.word_embeddings.weight"
    teacher_sd = seeded_weights(SEED + 1)
    teacher_sd[key] = teacher_sd[key][:student_sd[key].shape[0]]
    distill["f32_kernel_vs_plain"] = phase_distill_kernel_vs_plain(
        student_sd, teacher_sd, dstate.cluster_bank, dbatch)
    del dstate
    torch.cuda.empty_cache()
    lsa_cases.append(lsa_case("real_softkd", softkd[0].cpu().numpy(),
                              softkd[1].cpu().numpy(), "total", lsa_inputs))
    times["lsa"]["real_softkd"] = lsa_time(smi, lsa_cases[-1], lsa_inputs)
    ablation = phase_ablation(smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        dp = phase_dp(smi, root)
        torch.cuda.empty_cache()
        tp = phase_tp(smi, root)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        effnet = phase_effnet(smi, root, train)
        torch.cuda.empty_cache()
        remat = phase_remat(smi, state_dict, root, train)
    torch.cuda.empty_cache()
    parity = phase_parity(smi)

    serve = times["serving_encoder"]["bfloat16"][0.0]
    serve32 = times["serving_encoder"]["float32"][0.0]
    cross = times["serving_decoder_cross"]["bfloat16"][0.0]
    enc = times["train_encoder"]["bfloat16"]
    enc32 = times["train_encoder"]["float32"][0.0]
    lsa_main = times["lsa"]["continuous"]
    tl = train["launches"]
    dl = distill["launches"]
    bf16_attn = [c for c in attn if c["dtype"] == "bfloat16"]
    f32_route = "toist_tpu_torch/csrc/flash_attn_bwd.cu"

    def bound(t, kind):
        return {"bound_ms": t["bound"][kind][0],
                "bound_by": t["bound"][kind][1]}

    def dp_counts(kind):
        # Phase 14: launches per train step of each rank (all equal), by
        # run: (a) one rank, (b) two ranks.
        return {"dp_launches_per_step": {
            run: s["train_launches_per_step"][kind]
            for run, s in [("a", dp["a"])] + [(f"b_{k}", v) for k, v in
                                             dp["b"].items()]}}

    def p15_counts(kind):
        # Phase 15: launches per train step of the EfficientNet-B3 run (a),
        # with remat (b; 6 encoder forwards recomputed) and of each
        # tensor-parallel rank (c; on its 4 heads).
        return {"effnet_launches_per_step":
                effnet["train_launches_per_step"][kind],
                "remat_launches_per_step": remat["remat"]["launches"][0][kind],
                "tp_launches_per_step":
                tp["train_launches_per_step"][kind]}

    def tp_times(kind):
        # The TP-local shapes [6, 1156, 128] (4 heads) and the decoder
        # cross [6, 100, 128] over 1156 keys, bf16, rate 0.
        out = {}
        for name in ("tp_train_encoder", "tp_train_decoder_cross"):
            t = times[name]["bfloat16"][0.0]
            lib = "library_fwd" if kind == "fwd" else "library_bwd"
            out[name] = {"ms": t[kind], "plain_ms": t[
                "plain_fwd" if kind == "fwd" else "plain_bwd"],
                "library_ms": t[lib], **bound(t, kind)}
        return {"tp_shapes": out}

    def seg_counts(kind):
        # Phase 13: launches over its training steps and its eval batches.
        return {"seg_launches": seg["train_launches"][kind],
                "seg_eval_launches": seg["eval_launches"][kind]}

    # Every ms below is device_ms's device time per call (phase 10),
    # except the LSA plain version's, which runs on the host.
    record = {"kernels": [{
        "name": "flash_attn_fwd_tc",
        "route": "cuda",
        "source": "toist_tpu_torch/csrc/flash_attn_fwd_tc.cu",
        "replaces": "toist_tpu/ops/flash_attention.py:124",
        "launches": launches["fwd_tc"],
        "train_launches": tl["fwd_tc"],
        # Phase 11: tensor-core forwards in main's evaluate (both runs).
        "eval_launches": main_run["eval_tc_launches"],
        # Phase 12: distillation through main (24 per training step, 12
        # per cluster-eval batch), and its cluster evals alone.
        "distill_launches": dl["fwd_tc"],
        "distill_eval_launches": distill["eval_tc_launches"],
        **seg_counts("fwd_tc"),
        **dp_counts("fwd_tc"),
        **p15_counts("fwd_tc"),
        "parity_launches": parity["kernel_launches"]["fwd_tc"],
        **tp_times("fwd"),
        "max_abs_err": max(c["max_abs_err"] for c in cases
                           if c["dtype"] == "bfloat16"),
        "ms": serve["fwd"],
        "plain_ms": serve["plain_fwd"],
        **bound(serve, "fwd"),
        "exp_bound_ms": serve["exp_bound_ms"],
        "library_ms": serve["library_fwd"],
        "sdpa_backend": serve["sdpa_backend"],
        "decoder_cross": {"ms": cross["fwd"],
                          "library_ms": cross["library_fwd"],
                          **bound(cross, "fwd"),
                          "exp_bound_ms": cross["exp_bound_ms"]},
        "train_encoder_ms": enc[0.0]["fwd"],
        "ptxas": {k: v for k, v in ptxas.items() if "fwd_tc" in k},
        # f32 inputs take the scalar kernel (phases 5 and 9).
        "f32_route": {"source": "toist_tpu_torch/csrc/flash_attn_fwd.cu",
                      "launches": train_f32["launches_with"]["fwd"],
                      "ms": serve32["fwd"], "plain_ms": serve32["plain_fwd"],
                      **bound(serve32, "fwd"),
                      "library_ms": serve32["library_fwd"],
                      "ptxas": {k: v for k, v in ptxas.items()
                                if k.startswith("flash_fwd_kernel")}},
        "build_s": build_s,
        "cases": cases,
    }, {
        "name": "attn_dropout",
        "route": "cuda",
        "source": "toist_tpu_torch/csrc/attn_dropout.cuh",
        "replaces": "toist_tpu/ops/flash_attention.py:102",
        "launches": tl["dropout"],
        "distill_launches": dl["dropout"],
        **seg_counts("dropout"),
        **dp_counts("dropout"),
        **p15_counts("dropout"),
        "parity_launches": parity["kernel_launches"]["dropout"],
        "max_abs_err": max(c["max_abs_err"] for c in attn if c["rate"]),
        # The tensor-core forward at rate 0.1, and what the rate adds to
        # each of the three kernels (bf16, training encoder shape).
        "ms": enc[DROP_RATE]["fwd"],
        "plain_ms": enc[DROP_RATE]["plain_fwd"],
        **bound(enc[DROP_RATE], "fwd"),
        "exp_bound_ms": enc[DROP_RATE]["exp_bound_ms"],
        "library_ms": enc[DROP_RATE]["library_fwd"],
        "overhead_rate_0.1": enc["dropout_overhead"],
    }, {
        "name": "flash_attn_bwd_dkv_tc",
        "route": "cuda",
        "source": "toist_tpu_torch/csrc/flash_attn_bwd_tc.cu",
        "replaces": "toist_tpu/ops/flash_attention.py:147",
        "launches": tl["dkv_tc"],
        "distill_launches": dl["dkv_tc"],
        **seg_counts("dkv_tc"),
        **dp_counts("dkv_tc"),
        **p15_counts("dkv_tc"),
        "parity_launches": parity["kernel_launches"]["dkv_tc"],
        **tp_times("dkv"),
        "max_abs_err": max(c["max_abs_err"] for c in bf16_attn),
        "ms": enc[0.0]["dkv"],
        "ms_rate_0.1": enc[DROP_RATE]["dkv"],
        "plain_ms": enc[0.0]["plain_bwd"],
        **bound(enc[0.0], "dkv"),
        # SDPA's backward gives dQ, dK and dV together: the pair's yardstick.
        "library_ms": enc[0.0]["library_bwd"],
        "sdpa_backend": enc[0.0]["sdpa_backend"],
        "ptxas": {k: v for k, v in ptxas.items() if "dkv_tc" in k},
        # f32 inputs take the scalar kernel (phase 9's f32 step).
        "f32_route": {"source": f32_route, "ms": enc32["dkv"],
                      **bound(enc32, "dkv")},
        "cases": attn,
    }, {
        "name": "flash_attn_bwd_dq_tc",
        "route": "cuda",
        "source": "toist_tpu_torch/csrc/flash_attn_bwd_tc.cu",
        "replaces": "toist_tpu/ops/flash_attention.py:193",
        "launches": tl["dq_tc"],
        "distill_launches": dl["dq_tc"],
        **seg_counts("dq_tc"),
        **dp_counts("dq_tc"),
        **p15_counts("dq_tc"),
        "parity_launches": parity["kernel_launches"]["dq_tc"],
        **tp_times("dq"),
        "max_abs_err": max(c["max_abs_err"] for c in bf16_attn),
        "ms": enc[0.0]["dq"],
        "ms_rate_0.1": enc[DROP_RATE]["dq"],
        "plain_ms": enc[0.0]["plain_bwd"],
        **bound(enc[0.0], "dq"),
        "library_ms": enc[0.0]["library_bwd"],
        "ptxas": {k: v for k, v in ptxas.items() if "dq_tc" in k},
        "f32_route": {"source": f32_route, "ms": enc32["dq"],
                      **bound(enc32, "dq")},
    }, {
        "name": "lsa",
        "route": "cuda",
        "source": "toist_tpu_torch/csrc/lsa.cu",
        "replaces": "toist_tpu/ops/lsa_pallas.py:35",
        "launches": tl["lsa"],
        # Phase 12: 3 per distillation step (the noun and sth matchers, the
        # softkd re-pairing), 1 per cluster-eval batch.
        "distill_launches": dl["lsa"],
        **seg_counts("lsa"),
        **dp_counts("lsa"),
        **p15_counts("lsa"),
        "parity_launches": parity["kernel_launches"]["lsa"],
        "max_abs_err": 0,
        "ms": lsa_main["ms"],
        "plain_ms": lsa_main["plain_ms"],
        "bound_ms": lsa_main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,          # no PyTorch call solves an assignment
        "steps_longest": lsa_main["steps_longest"],
        "ns_per_step": lsa_main["ns_per_step"],
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("lsa")},
        "shapes": times["lsa"],
        "cases": lsa_cases,
    }], "train": {k: train[k] for k in ("launches", "peak_gib", "img_s",
                                        "profile")},
        "main": {k: main_run[k] for k in ("eval_runs", "mean_ap50",
                                          "checkpoints", "launches",
                                          "train_steps")},
        "distill": {k: distill[k] for k in (
            "eval_runs", "mean_ap50", "checkpoints", "launches",
            "train_steps", "pairs_s", "peak_gib", "profile", "cluster",
            "bank_update_count", "f32_kernel_vs_plain")},
        "seg": {k: seg[k] for k in (
            "train_steps", "img_s", "step_ms", "peak_gib_train",
            "peak_gib_with_eval", "resident_gib_before", "eval_runs",
            "mask_ap50", "checkpoints",
            "train_launches", "eval_launches", "profile", "dis",
            "f32_kernel_vs_plain", "predictor")},
        "ablation": ablation, "dp": dp,
        "effnet": {k: effnet[k] for k in (
            "backbone", "step_ms_median", "traced_step_ms_median",
            "phase8_step_ms_median",
            "step_ms_ratio_to_phase8", "img_s", "peak_gib",
            "pretrained_tensors_landed", "mean_ap50", "profile_lines",
            "trace_mib", "predictor", "visualize", "f32_kernel_vs_plain",
            "seconds")},
        "remat": remat, "parity": parity,
        "tp": {k: tp[k] for k in (
            "step_ms_median", "model_allreduce_per_step",
            "moment_bytes_per_rank", "sharded_elements_per_rank",
            "tp_vs_one_process_f32", "fwd_shapes", "parts_s",
            "seconds_phase")}}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
