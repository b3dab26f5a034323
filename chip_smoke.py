#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (toist_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, each of which raises on failure (non-zero exit):
  1. device: the card's name and power limit, and whether nvcc, triton and
     PIL are present;
  2. build: the hand-written CUDA kernel, built with nvcc from
     toist_tpu_torch/csrc into build/kernels;
  3. kernel vs plain: the flash-attention forward against its plain PyTorch
     version at the slice's shapes (encoder self-attention [8,S,256] and
     decoder cross-attention [8,100,256] over [8,S,256], 8 heads, S = 1114
     on the 800x1344 serving canvas and 1156 on 832x1344), with
     and without a key padding mask, in f32 (TF32 off, atol 2e-5) and bf16
     (atol/rtol 3e-2), and CUDA-event times of both;
  4. slice at full width: the serving path (Predictor -> TOIST encode/decode
     -> postprocess_boxes) with ResNet-101, RoBERTa-base and a 6+6-layer
     d256 transformer in bf16, weights random from a seed in the reference
     checkpoint's layout, answering batches of 8 on the 800x1344 and
     1344x800 canvases; every forward must launch the kernel 12 times;
  5. slice kernel vs plain: the same weights in f32 (TF32 off) on one batch,
     once through the kernel and once through the plain attention;
     pred_logits and pred_boxes must agree within 2e-3.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. There is no CPU path.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

SEED = 0
B, H, D = 8, 8, 256        # eval batch, attention heads, d_model
NUM_QUERIES = 100
TOL = {"float32": (2e-5, 0.0), "bfloat16": (3e-2, 3e-2)}   # (atol, rtol)
SLICE_TOL = 2e-3
LAUNCHES_PER_FORWARD = 12   # 6 encoder self-attn + 6 decoder cross-attn


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, warmup=3, iters=20):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
        f"PIL {'present' if has_pil else 'absent'}")
    return smi, has_pil


def phase_build():
    from toist_tpu_torch.ops import _build
    from toist_tpu_torch.ops.flash_attention import KERNEL_SOURCE

    _build.load_library(KERNEL_SOURCE)
    secs = _build.BUILD_SECONDS[KERNEL_SOURCE]
    log(f"[build] {KERNEL_SOURCE}: {secs:.2f} s")
    return secs


def attention_shapes():
    """(name, Sq, S) of the kernel's calls. The serving path's canvas is
    800x1344 (batcher.default_buckets: the short side 800 is already a
    multiple of 32), so its joint sequence is 25*42 image + 64 text = 1114
    tokens; 832x1344, the top training canvas, gives 26*42 + 64 = 1156."""
    from toist_tpu.config import Config
    from toist_tpu.data.batcher import default_buckets

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
                o, lse = flash_attention(q, k, v, m, H)
                torch.cuda.synchronize()
                ro, rlse = attention_plain(q, k, v, m, H)
                err = (o.float() - ro.float()).abs().max().item()
                # Fully masked rows have lse near -1.44e9, so relative.
                lse_err = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)
                           ).max().item()
                ok = (torch.isfinite(o).all().item() and torch.allclose(
                    o.float(), ro.float(), atol=atol, rtol=rtol)
                    and lse_err < 1e-5)
                case = {"shape": shape_name, "q": [B, Sq, D], "kv": [B, S, D],
                        "dtype": dt_name, "mask": m_name,
                        "max_abs_err": err, "lse_max_rel_err": lse_err,
                        "atol": atol, "rtol": rtol}
                if m_name == "mask":
                    case["ms"] = cuda_ms(lambda: flash_attention(q, k, v, m,
                                                                 H))
                    case["plain_ms"] = cuda_ms(lambda: attention_plain(
                        q, k, v, m, H))
                log(f"[kernel] {json.dumps(case)}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with plain: "
                                         f"{case}")
                cases.append(case)
    return cases


def _requests(rng, spec, predictor, cfg):
    """Three collated batches: 8 landscape, 4 landscape (half empty) and 8
    portrait images, with mixed task ids."""
    from toist_tpu.data.batcher import collate

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

    from toist_tpu.config import Config
    from toist_tpu.utils.convert import (convert_torch_state_dict,
                                         synth_reference_state_dict)
    from toist_tpu_torch.ops.flash_attention import flash_attention
    from toist_tpu_torch.predict import Predictor
    from toist_tpu_torch.utils.convert import jax_params_to_state_dict

    cfg = Config.from_sources(None, {"run": {"compute_eval_losses": False}})
    m = cfg.model
    t0 = time.perf_counter()
    sd = synth_reference_state_dict(
        stage_sizes=(3, 4, 23, 3), enc=m.enc_layers, dec=m.dec_layers,
        d=m.hidden_dim, dim_feedforward=m.dim_feedforward,
        text_layers=m.text_layers, text_hidden=m.text_hidden,
        text_intermediate=m.text_intermediate, num_queries=m.num_queries,
        contrastive_hdim=m.contrastive_hdim, with_masks=False, seed=SEED)
    params, frozen = convert_torch_state_dict(
        sd, d_model=m.hidden_dim, enc_layers=m.enc_layers,
        dec_layers=m.dec_layers, stage_sizes=(3, 4, 23, 3))
    state_dict = jax_params_to_state_dict(params, frozen)
    del sd, params, frozen
    predictor = Predictor.from_state_dict(state_dict, cfg, device="cuda")
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
    flash_attention.launches = 0
    lat = []
    for rep in range(3):
        for b in batches:
            before = flash_attention.launches
            t = time.perf_counter()
            res = predictor.predict_batch(b)   # ends in a device->host copy
            dt = time.perf_counter() - t
            n_valid = int(b["sample_valid"].sum())
            _check_results(res, n_valid, m.num_queries)
            got = flash_attention.launches - before
            if got != LAUNCHES_PER_FORWARD:
                raise AssertionError(f"{got} kernel launches in one forward")
            lat.append((b["images"].shape[1:3], n_valid, dt))
    if has_pil:
        from PIL import Image

        imgs = [Image.fromarray(rng.integers(0, 256, (480, 640, 3),
                                             dtype="uint8")),
                Image.fromarray(rng.integers(0, 256, (700, 500, 3),
                                             dtype="uint8"))]
        before = flash_attention.launches
        dets = predictor(imgs, task_ids=[3, 11])
        _check_results(dets, 2, m.num_queries)
        if flash_attention.launches - before != 2 * LAUNCHES_PER_FORWARD:
            raise AssertionError("Predictor.__call__ did not run the kernel "
                                 "in both of its forwards")
        log(f"[slice] Predictor.__call__ on 2 PIL images: ok")
    launches = flash_attention.launches

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

    from toist_tpu.config import Config
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


def main() -> int:
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.getcwd())
    # The native tokenizer library builds inside the checkout.
    os.environ.setdefault("TOIST_NATIVE_DIR",
                          os.path.join(os.getcwd(), "build", "native"))
    import torch

    smi, has_pil = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = phase_build()
    cases = phase_kernel_vs_plain()
    state_dict, batch, launches = phase_slice(smi, has_pil)
    phase_slice_kernel_vs_plain(state_dict, batch)

    main_case = next(c for c in cases if c["shape"] == "encoder"
                     and c["dtype"] == "bfloat16" and c["mask"] == "mask")
    record = {"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "toist_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "toist_tpu/ops/flash_attention.py:124",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "build_s": build_s,
        "cases": cases,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
