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
     floor of the card's special-function units.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. There is no CPU path.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
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


def attention_bound(kind, b, sq, s, dtype_name):
    """(bound ms, "operations" or "bytes") of one attention kernel call:
    its products over the card's peak rate for the dtype, against its
    inputs read once and outputs written once over the memory rate."""
    e = 2 if dtype_name == "bfloat16" else 4
    q_b, kv_b = b * sq * D * e, b * s * D * e
    rows_f32 = b * H * sq * 4                 # lse or D, [B, H, Sq] f32
    mask_b = b * s                            # key padding mask, u8
    nbytes = {"fwd": q_b + 2 * kv_b + mask_b + q_b + rows_f32,
              "dkv": 2 * q_b + 2 * kv_b + mask_b + 2 * rows_f32 + 2 * kv_b,
              "dq": 2 * q_b + 2 * kv_b + mask_b + 2 * rows_f32 + q_b}[kind]
    flops = PRODUCTS[kind] * 2 * b * sq * s * D
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def exp_bound(b, sq, s):
    """ms the card's special-function units take for one exp2 per score
    (b * H * sq * s of them) at the maximum SM clock: the floor of a
    forward whose products are too shallow (hd 32) to be its limit."""
    rate = EX2_PER_CLOCK_PER_SM * CARD["sms"] * CARD["max_sm_mhz"] * 1e6
    return b * H * sq * s / rate * 1e3


def _sdpa_inputs(q, k, v, mask):
    """[B, H, S, hd] copies of q, k, v and a boolean attn_mask [B, 1, 1, S]
    (True = take part) in which every row keeps at least one real key:
    SDPA's inputs for the library yardstick, made outside any timed region.
    """
    import torch

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], H, -1).transpose(1, 2) \
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


def attention_shapes():
    """(name, Sq, S) of the kernel's calls. The serving path's canvas is
    800x1344 (batcher.default_buckets: the short side 800 is already a
    multiple of 32), so its joint sequence is 25*42 image + 64 text = 1114
    tokens; 832x1344, the top training canvas, gives 26*42 + 64 = 1156."""
    from toist_tpu_torch.config import Config
    from toist_tpu_torch.data.batcher import default_buckets

    data = Config().data
    h, w = default_buckets(data.max_size, data.val_size)[0]
    s_eval = (h // 32) * (w // 32) + data.max_text_len
    s_832 = (832 // 32) * (1344 // 32) + data.max_text_len
    return [("encoder", s_eval, s_eval),
            ("decoder_cross", NUM_QUERIES, s_eval),
            ("encoder_832x1344", s_832, s_832),
            ("decoder_cross_832x1344", NUM_QUERIES, s_832)]


def phase_kernel_vs_plain():
    import torch

    from toist_tpu_torch.ops.flash_attention import (attention_plain,
                                                     flash_attention)

    fa = flash_attention
    g = torch.Generator().manual_seed(SEED)
    cases = []
    for shape_name, Sq, S in attention_shapes():
        q32 = torch.randn((B, Sq, D), generator=g)
        k32 = torch.randn((B, S, D), generator=g)
        v32 = torch.randn((B, S, D), generator=g)
        mask = torch.rand(B, S, generator=g) < 0.2
        mask[B - 1] = True                      # one fully masked row
        mask = mask.cuda()
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v = (t.to("cuda", dt) for t in (q32, k32, v32))
            atol, rtol = TOL[dt_name]
            for m_name, m in (("mask", mask), ("no_mask", None)):
                before = (fa.launches, fa.fwd_tc_launches)
                o, lse = flash_attention(q, k, v, m, H)
                torch.cuda.synchronize()
                # bf16 runs the tensor-core kernel, f32 the scalar one.
                route = {"fwd": fa.launches - before[0],
                         "fwd_tc": fa.fwd_tc_launches - before[1]}
                ro, rlse = attention_plain(q, k, v, m, H)
                err = (o.float() - ro.float()).abs().max().item()
                # The scale-aware check, against the plain version in f32.
                rel = _rel_err(o, attention_plain(q.float(), k.float(),
                                                  v.float(), m, H)[0])
                # Fully masked rows have lse near -1.44e9, so relative.
                lse_err = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)
                           ).max().item()
                ok = (torch.isfinite(o).all().item() and torch.allclose(
                    o.float(), ro.float(), atol=atol, rtol=rtol)
                    and rel <= REL_TOL[dt_name]
                    and lse_err < 1e-5 and route == {
                        "fwd": 1, "fwd_tc": int(dt == torch.bfloat16)})
                case = {"shape": shape_name, "q": [B, Sq, D], "kv": [B, S, D],
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


def phase_slice(smi, has_pil):
    import numpy as np
    import torch

    from toist_tpu_torch.config import Config
    from toist_tpu_torch.ops.flash_attention import flash_attention
    from toist_tpu_torch.predict import Predictor
    from toist_tpu_torch.utils.convert import synth_reference_state_dict

    cfg = Config.from_sources(None, {"run": {"compute_eval_losses": False}})
    m = cfg.model
    t0 = time.perf_counter()
    sd = synth_reference_state_dict(
        stage_sizes=(3, 4, 23, 3), enc=m.enc_layers, dec=m.dec_layers,
        d=m.hidden_dim, dim_feedforward=m.dim_feedforward,
        text_layers=m.text_layers, text_hidden=m.text_hidden,
        text_intermediate=m.text_intermediate, num_queries=m.num_queries,
        contrastive_hdim=m.contrastive_hdim, with_masks=False, seed=SEED)
    state_dict = {k: torch.from_numpy(v) for k, v in sd.items()}
    del sd
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


def _kernel_kind(name):
    """Coarse kind of a CUDA kernel, from its name."""
    low = name.lower()
    for kind, keys in (
            ("attention forward", ("flash_fwd",)),
            ("attention dK/dV", ("flash_bwd_dkv",)),
            ("attention dQ", ("flash_bwd_dq",)),
            ("LSA", ("lsa",)),
            ("optimizer (foreach)", ("multi_tensor", "foreach")),
            ("GEMM / convolution", ("gemm", "xmma", "cutlass", "conv",
                                    "cudnn", "sm90", "sm80", "nhwc",
                                    "nchw", "wgrad", "dgrad", "fprop")),
            ("reduction", ("reduce", "norm", "softmax", "cunn_",
                           "cross_entropy")),
            ("copy / memset", ("memcpy", "memset", "copy")),
            ("elementwise", ("elementwise", "vectorized", "unrolled",
                             "index", "where"))):
        if any(k in low for k in keys):
            return kind
    return "other"


def _profile_steps(smi, step, state, it, canvas, n=3):
    """torch.profiler over n bf16 training steps on one canvas after a
    warm-up step there: device kernel ms per step by kind and by attention
    kernel, against the host-clock ms of n unprofiled steps (busy share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [b for b in it.epoch(2, num_workers=1)
               if tuple(b["images"].shape[1:3]) == canvas]
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
    for e in prof.key_averages():
        # Device events only; a user annotation (the optimizer's
        # "Optimizer.step#..." range) spans kernels counted on their own.
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms = us / 1e3 / n
        kind = _kernel_kind(e.key)
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
    if kernel_ms <= 0:      # the profiler saw no device time: not measured
        res = {"canvas": list(canvas), "wall_ms": wall,
               "kernel_ms_per_step": "not measured"}
    log(f"[profile] bf16 training step {json.dumps(res)} | {smi}")
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


def _attention_times(q, k, v, mask, w, rate, backward):
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
        keep = fa.dropout_keep_mask(seed, b, H, sq, s, rate)
    sq_, sk_, sv_, sm_ = _sdpa_inputs(q, k, v, mask)

    def sdpa():
        return F.scaled_dot_product_attention(sq_, sk_, sv_, sm_,
                                              dropout_p=rate)

    t = {"fwd": device_ms(lambda: fa._launch_fwd(q, k, v, mask_u8, H,
                                                  drop_q, seed)),
         "plain_fwd": device_ms(lambda: fa.attention_plain(
             q, k, v, mask, H, keep, rate))}
    with torch.no_grad():
        t["library_fwd"] = device_ms(sdpa)
    t["sdpa_backend"] = sdpa_backend(sq_, sk_, sv_, sm_, rate)
    if not backward:
        return t
    o, lse = fa._launch_fwd(q, k, v, mask_u8, H, drop_q, seed)
    do = w.to(q.dtype).contiguous()
    args = (q, k, v, mask_u8, do, lse, fa.row_dsum(do, o, H), H, drop_q,
            seed)
    t["dkv"] = device_ms(lambda: fa._launch_dkv(*args))
    t["dq"] = device_ms(lambda: fa._launch_dq(*args))
    qp, kp, vp = (x.detach().requires_grad_() for x in (q, k, v))
    op = fa.attention_plain(qp, kp, vp, mask, H, keep, rate)[0]
    t["plain_bwd"] = device_ms(lambda: torch.autograd.grad(
        op, (qp, kp, vp), do, retain_graph=True))
    sq_, sk_, sv_ = (x.requires_grad_() for x in (sq_, sk_, sv_))
    sdo = do.reshape(b, sq, H, -1).transpose(1, 2).contiguous()
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

    from toist_tpu_torch.ops.lsa import solve_lsa_batch

    s_eval = attention_shapes()[0][2]
    s_832 = (832 // 32) * (1344 // 32) + 64
    g = torch.Generator().manual_seed(SEED + 2)
    out = {}
    for name, b, sq, s, backward in (
            ("serving_encoder", B, s_eval, s_eval, False),
            ("serving_decoder_cross", B, NUM_QUERIES, s_eval, False),
            ("train_encoder", TRAIN_B, s_832, s_832, True),
            ("train_decoder_cross", TRAIN_B, NUM_QUERIES, s_832, True)):
        q32, k32, v32, w = (torch.randn((b, n, D), generator=g)
                            for n in (sq, s, s, sq))
        mask = torch.rand(b, s, generator=g) < 0.2
        mask[b - 1] = True                      # one fully masked row
        mask, w = mask.cuda(), w.cuda()
        out[name] = {}
        for dt_name, dt in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            if dt == torch.float32 and "encoder" not in name:
                continue
            q, k, v = (x.to("cuda", dt) for x in (q32, k32, v32))
            rates = (0.0, DROP_RATE) if backward and dt == torch.bfloat16 \
                else (0.0,)
            per = {}
            for rate in rates:
                per[rate] = _attention_times(q, k, v, mask, w, rate,
                                             backward)
                per[rate]["bound"] = {
                    kind: attention_bound(kind, b, sq, s, dt_name)
                    for kind in (PRODUCTS if backward else ("fwd",))}
                per[rate]["exp_bound_ms"] = exp_bound(b, sq, s)
            log(f"[times] {name} [{b},{sq},{D}] over [{b},{s},{D}] "
                f"{dt_name}: {json.dumps(per)}")
            if DROP_RATE in per:
                per["dropout_overhead"] = {
                    kind: per[DROP_RATE][kind] / per[0.0][kind] - 1.0
                    for kind in PRODUCTS}
                log(f"[times] {name} {dt_name}: rate {DROP_RATE} adds "
                    f"{json.dumps(per['dropout_overhead'])} of each "
                    f"kernel's rate-0 time")
            out[name][dt_name] = per
    out["lsa"] = {}
    for case in lsa_cases:
        if case["case"] not in lsa_inputs:
            continue
        c, n = lsa_inputs[case["case"]]
        ms = device_ms(lambda: solve_lsa_batch(c, n))
        out["lsa"][case["case"]] = t = {
            "shape": case["shape"], "ms": ms, "bound_ms": case["bound_ms"],
            "bound_by": "bytes", "plain_ms": case["plain_ms"],
            "steps_longest": case["steps_longest"],
            "ns_per_step": ms * 1e6 / max(case["steps_longest"], 1)}
        log(f"[times] lsa {case['case']} {json.dumps(t)} | {smi}")
    return out


def main() -> int:
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.getcwd())
    import torch

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

    serve = times["serving_encoder"]["bfloat16"][0.0]
    serve32 = times["serving_encoder"]["float32"][0.0]
    cross = times["serving_decoder_cross"]["bfloat16"][0.0]
    enc = times["train_encoder"]["bfloat16"]
    enc32 = times["train_encoder"]["float32"][0.0]
    lsa_main = times["lsa"]["continuous"]
    tl = train["launches"]
    bf16_attn = [c for c in attn if c["dtype"] == "bfloat16"]
    f32_route = "toist_tpu_torch/csrc/flash_attn_bwd.cu"

    def bound(t, kind):
        return {"bound_ms": t["bound"][kind][0],
                "bound_by": t["bound"][kind][1]}

    # Every ms below is device_ms's device time per call (phase 10),
    # except the LSA plain version's, which runs on the host.
    record = {"kernels": [{
        "name": "flash_attn_fwd_tc",
        "route": "cuda",
        "source": "toist_tpu_torch/csrc/flash_attn_fwd_tc.cu",
        "replaces": "toist_tpu/ops/flash_attention.py:124",
        "launches": launches["fwd_tc"],
        "train_launches": tl["fwd_tc"],
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
                                        "profile")}}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
