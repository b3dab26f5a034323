"""The CUDA kernels on the card, against their plain versions.

Marked ``cuda``: these tests need an NVIDIA GPU and nvcc, and skip
elsewhere. On the card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Tolerances: forward f32 with TF32 off 2e-5 (only the order of the sums
differs), bf16 3e-2 (as tests/test_flash_attention.py). Forward and
gradients against the plain version in f32 on the same inputs, as the
largest error over the tensor's max abs value: f32 5e-5 (sums over up to
300 rows in another order); bf16 (the tensor-core route) 1.5e-2, where the
kernels accumulate in f32 and round P~, dS and the outputs to bf16 as
FlashAttention-2 does, so a kernel that is 5% off fails. The same seed
reproduces them bit for bit. LSA: exact assignments on continuous costs and
ties (the kernel and the plain version run the same algorithm in the same f32
order), at the matcher and softkd shapes and at the edges of the kernel's
layout (many problems per CTA, C not a multiple of 4 or 32, R = 1, signed
zeros, more than 128 columns).
"""
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from toist_tpu_torch.models.layers import MultiheadAttention
from toist_tpu_torch.ops.flash_attention import (FlashAttention,
                                                 attention_plain,
                                                 drop_threshold,
                                                 dropout_keep_mask,
                                                 dropout_keep_mask_plain,
                                                 flash_attention)
from toist_tpu_torch.ops.lsa import (softkd_like_costs, solve_lsa_batch,
                                     solve_lsa_batch_plain)

pytestmark = pytest.mark.cuda
REL = {torch.float32: 5e-5, torch.bfloat16: 1.5e-2}   # x max abs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(sq, s, d, dtype, mask_kind, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, n, d, generator=g) for n in (sq, s, s))
    mask = {"random": torch.rand(2, s, generator=g) < 0.2,
            "full": torch.ones(2, s, dtype=torch.bool), "none": None}[
                mask_kind]
    out = [t.to("cuda", dtype) for t in (q, k, v)]
    return out + [None if mask is None else mask.cuda()]


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 0.0),
                                             (torch.bfloat16, 3e-2, 3e-2)])
@pytest.mark.parametrize("sq,s", [(300, 300), (100, 300), (37, 70)])
@pytest.mark.parametrize("heads,d", [(8, 256), (4, 64)])
@pytest.mark.parametrize("mask_kind", ["random", "full", "none"])
def test_kernel_matches_plain(cuda, dtype, atol, rtol, sq, s, heads, d,
                              mask_kind):
    q, k, v, mask = _inputs(sq, s, d, dtype, mask_kind)
    before = flash_attention.launches
    before_tc = flash_attention.fwd_tc_launches
    o, lse = flash_attention(q, k, v, mask, heads)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    # bf16 runs the tensor-core forward, f32 the scalar one.
    assert flash_attention.fwd_tc_launches == before_tc + (
        dtype == torch.bfloat16)
    ro, rlse = attention_plain(q, k, v, mask, heads)
    assert o.dtype == dtype and torch.isfinite(o).all()
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)
    _close(o, attention_plain(q.float(), k.float(), v.float(), mask,
                              heads)[0], REL[dtype])


def test_module_launches_only_for_long_keys(cuda):
    mha = MultiheadAttention(256, 8).to(cuda).eval()
    x = torch.randn(2, 100, 256, device=cuda)
    for s, launched in ((100, 0), (255, 0), (256, 1), (300, 1)):
        mem = torch.randn(2, s, 256, device=cuda)
        before = flash_attention.launches
        with torch.inference_mode():
            mha(x, mem, mem)
        assert flash_attention.launches - before == launched


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, mask = _inputs(64, 64, 256, torch.float32, "random")
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, v, mask, 4)                     # hd 64
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), mask, 8)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                        k, v, mask, 8)
    with pytest.raises(ValueError, match="generator"):
        flash_attention(q, k, v, mask, 8, dropout_rate=0.1)


def _grads(fn, q, k, v, w):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(q, k, v)
    dq, dk, dv = torch.autograd.grad((o.float() * w).sum(), (q, k, v))
    return o.detach(), dq, dk, dv


def _close(got, want, rel):
    """Largest error within rel of want's max abs (exact where want is 0)."""
    scale = want.abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * scale, (err, rel * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,s", [(300, 300), (100, 300), (37, 70)])
@pytest.mark.parametrize("heads,d", [(8, 256), (4, 64)])
@pytest.mark.parametrize("mask_kind", ["random", "full", "none"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernels_with_gradients_match_plain(cuda, dtype, sq, s, heads, d,
                                            mask_kind, rate):
    """Forward and dQ/dK/dV of the kernels against autograd through the plain
    version given the kernels' own dropout mask; "random" masks hold a fully
    masked row (batch element 1), whose dQ and dK must be 0."""
    q, k, v, mask = _inputs(sq, s, d, dtype, mask_kind, seed=3)
    if mask_kind == "random":
        mask[1] = True
    w = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4))
    seed = torch.tensor([1234567], dtype=torch.int64, device=cuda)
    dq_ = drop_threshold(rate)
    keep = (dropout_keep_mask(seed, 2, heads, sq, s, rate) if dq_ else None)
    mask_u8 = None if mask is None else mask.view(torch.uint8)
    names = ("launches", "dkv_launches", "dq_launches", "fwd_tc_launches",
             "dkv_tc_launches", "dq_tc_launches")
    counts = [getattr(flash_attention, n) for n in names]

    def kernels(a, b, c):
        return FlashAttention.apply(a, b, c, mask_u8, heads, dq_,
                                    seed if dq_ else None)[0]

    got = _grads(kernels, q, k, v, w)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)      # the tensor-core route is bf16's
    assert [getattr(flash_attention, n) - c for n, c in
            zip(names, counts)] == [1, 1, 1, tc, tc, tc]
    again = _grads(kernels, q, k, v, w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = _grads(lambda a, b, c: attention_plain(
        a.float(), b.float(), c.float(), mask, heads, keep, rate)[0],
        q, k, v, w)
    for g, r in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        _close(g, r, REL[dtype])
    if mask_kind != "none":
        full = mask.all(dim=1)
        assert (got[1][full] == 0).all() and (got[2][full] == 0).all()


def test_dropout_bits_reproduce_and_keep_rate(cuda):
    seed = torch.tensor([99], dtype=torch.int64, device=cuda)
    a = dropout_keep_mask(seed, 6, 8, 1156, 1156, 0.1)
    b = dropout_keep_mask(seed, 6, 8, 1156, 1156, 0.1)
    c = dropout_keep_mask(seed + 1, 6, 8, 1156, 1156, 0.1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    keep = a.float().mean().item()
    assert abs(keep - (1 - 26 / 256)) < 1e-3, keep
    # Rows and columns are not correlated: per-row shares stay near the mean.
    assert a.float().mean(-1).std().item() < 0.02
    q, k, v, mask = _inputs(300, 300, 256, torch.float32, "random")
    o1, _ = FlashAttention.apply(q, k, v, mask.view(torch.uint8), 8, 26, seed)
    o2, _ = FlashAttention.apply(q, k, v, mask.view(torch.uint8), 8, 26, seed)
    assert torch.equal(o1, o2)


@pytest.mark.parametrize("b,h,sq,s,rate", [(6, 8, 1156, 1156, 0.1),
                                            (6, 8, 100, 1156, 0.1),
                                            (2, 4, 37, 70, 0.5)])
def test_dropout_mask_equals_plain_bit_for_bit(cuda, b, h, sq, s, rate):
    """The kernels' bit function (attn_dropout.cuh, through the mask kernel)
    against its numpy version, for a seed with high bits set."""
    value = 0x5DEECE66D1234567
    seed = torch.tensor([value], dtype=torch.int64, device=cuda)
    got = dropout_keep_mask(seed, b, h, sq, s, rate).cpu()
    assert torch.equal(got, dropout_keep_mask_plain(value, b, h, sq, s, rate))


def test_module_dropout_draws_from_the_generator(cuda):
    mha = MultiheadAttention(256, 8, dropout=0.1).to(cuda).train()
    x = torch.randn(2, 100, 256, device=cuda)
    mem = torch.randn(2, 300, 256, device=cuda)
    outs = []
    for s in (1, 1, 2):
        g = torch.Generator(cuda).manual_seed(s)
        outs.append(mha(x, mem, mem, generator=g))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


LSA_CASES = ("continuous", "padded", "ties", "non_finite", "100x100",
             "softkd", "b300", "128x128", "40x25x37", "r1", "signed_zero_ties",
             "c200")


def _lsa_case(name):
    """(cost, n_rows) of one LSA case. b300: more problems than SMs, so
    several per CTA and more than one wave; 40x25x37: C neither a multiple
    of 32 nor of 4 (scalar loads); signed_zero_ties: -0.0 and +0.0 tie;
    c200: more than 128 columns (column state in shared memory)."""
    rng = np.random.default_rng(0)
    cont = rng.normal(size=(36, 25, 100)).astype(np.float32)
    ties = np.round(rng.uniform(size=(36, 25, 100)) * 3).astype(np.float32)
    nan = cont.copy()
    nan[0, 3] = np.nan
    nan[1] = np.inf
    big = rng.normal(size=(36, 100, 100)).astype(np.float32)
    n25 = rng.integers(0, 26, 36).astype(np.int32)
    if name in ("continuous", "padded", "ties", "non_finite", "100x100"):
        return {"continuous": (cont, np.full(36, 25, np.int32)),
                "padded": (cont, n25), "ties": (ties, n25),
                "non_finite": (nan, np.full(36, 25, np.int32)),
                "100x100": (big, rng.integers(60, 101, 36).astype(np.int32))
                }[name]
    if name == "softkd":
        return softkd_like_costs(5, 36)
    shape, n_range = {"b300": ((300, 25, 100), (0, 26)),
                      "128x128": ((16, 128, 128), (100, 129)),
                      "40x25x37": ((40, 25, 37), (0, 26)),
                      "r1": ((16, 1, 50), (0, 2)),
                      "signed_zero_ties": ((36, 20, 40), (10, 21)),
                      "c200": ((8, 60, 200), (40, 61))}[name]
    if name == "signed_zero_ties":
        cost = rng.choice(np.array([0.0, -0.0, 1.0], np.float32), shape)
    else:
        cost = rng.normal(size=shape).astype(np.float32)
    return cost, rng.integers(*n_range, shape[0]).astype(np.int32)


@pytest.mark.parametrize("name", LSA_CASES)
def test_lsa_kernel_matches_plain(cuda, name):
    cost, n = _lsa_case(name)
    before = solve_lsa_batch.launches
    got = solve_lsa_batch(torch.from_numpy(cost).to(cuda),
                          torch.from_numpy(n).to(cuda))
    torch.cuda.synchronize()
    assert solve_lsa_batch.launches == before + 1
    want = solve_lsa_batch_plain(torch.from_numpy(cost), torch.from_numpy(n))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                  err_msg=name)
    if name in ("continuous", "padded", "100x100", "b300", "128x128",
                "40x25x37", "r1", "c200"):
        for b in range(cost.shape[0]):
            rows, cols = linear_sum_assignment(cost[b, :n[b]])
            np.testing.assert_array_equal(got[b, :n[b]].cpu().numpy(), cols)


def test_lsa_wrapper_raises(cuda):
    with pytest.raises(ValueError, match="R <= C"):
        solve_lsa_batch(torch.zeros(2, 5, 4, device=cuda),
                        torch.ones(2, dtype=torch.int32, device=cuda))


def _tiny_eval_setup(tmp_path, compute_dtype):
    """The fixture (2 tasks x 4 images) on a 448x640 canvas (14 x 20 image
    tokens + 48 text: the joint attention reaches the kernel) and the tiny
    model of tests/test_torch_train.py in ``compute_dtype``."""
    from toist_tpu_torch.config import Config
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.data.cocotasks import build_task_dataset
    from toist_tpu_torch.data.fixtures import generate_fixture
    from toist_tpu_torch.main import build_specs
    from toist_tpu_torch.utils.convert import synth_reference_state_dict

    root = generate_fixture(str(tmp_path), num_tasks=2, imgs_per_split=4,
                            img_size=(96, 128), seed=1)
    cfg = Config.from_sources(None, {
        "model": {"backbone": "resnet18-test", "hidden_dim": 64,
                  "nheads": 4, "dim_feedforward": 128, "enc_layers": 2,
                  "dec_layers": 2, "num_queries": 20, "text_hidden": 64,
                  "text_layers": 2, "text_heads": 4, "text_intermediate": 128,
                  "contrastive_hdim": 16, "compute_dtype": compute_dtype},
        "data": {"coco_path": root, "refexp_ann_path": f"{root}/annotations",
                 "tasks": [1, 2], "image_buckets": [[448, 640]],
                 "max_text_len": 48, "max_boxes": 8, "max_size": 640,
                 "val_size": 96}})
    tok = build_tokenizer(cfg)
    sets = {t: build_task_dataset(cfg.data, t, "val", tok)
            for t in cfg.data.tasks}
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=2, dec=2, d=64, dim_feedforward=128,
        text_layers=2, text_hidden=64, text_intermediate=128, num_queries=20,
        vocab_size=tok.vocab_size, contrastive_hdim=16, with_masks=False,
        seed=5)
    return cfg, sets, build_specs(cfg)[1], {
        k: torch.from_numpy(v) for k, v in sd.items()}


def test_evaluate_on_the_card_matches_the_cpu(cuda, tmp_path):
    """evaluate with the tiny model in bf16 on the card against f32 on the
    CPU: each batch's detections within 1.5e-2 of the CPU's max abs, the
    tensor-core forward launched, finite stats."""
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.train import engine
    from toist_tpu_torch.train.criterion import build_weight_dict
    from toist_tpu_torch.train.step import make_eval_step

    dets = {}
    for dev, dt in (("cpu", "float32"), ("cuda", "bfloat16")):
        cfg, sets, spec, sd = _tiny_eval_setup(tmp_path / dev, dt)
        model = TOIST.from_state_dict(sd, cfg.model, device=dev)
        step = make_eval_step(model, cfg, build_weight_dict(cfg.loss, False,
                                                            2))
        dets[dev] = []

        def recording(batch, step=step, out=dets[dev]):
            res = step(batch)
            out.append({k: res["post"][k].float().cpu()
                        for k in ("scores", "boxes")})
            return res

        before = flash_attention.fwd_tc_launches
        res = engine.evaluate(recording, sets, spec, batch_size=3)
        assert all(np.isfinite(s["bbox"]).all() for s in res.values())
    # 4 batches x (2 encoder self + 2 decoder cross attentions)
    assert flash_attention.fwd_tc_launches - before == 4 * 4
    assert len(dets["cuda"]) == len(dets["cpu"]) == 4
    for got, want in zip(dets["cuda"], dets["cpu"]):
        for k in ("scores", "boxes"):
            _close(got[k], want[k], REL[torch.bfloat16])


def test_evaluate_double_buffer_hands_each_batch_its_results(cuda, tmp_path,
                                                              monkeypatch):
    """A fake eval step whose boxes encode the image id, computed on the
    card behind a spin kernel so that each batch's copies are still in
    flight when the next batch is issued: every update gets its own
    batch's image ids and boxes."""
    from toist_tpu_torch.train import engine

    cfg, sets, spec, _ = _tiny_eval_setup(tmp_path, "bfloat16")
    updates = []

    class Recording(engine.TaskEvaluator):
        def update(self, image_ids, scores, boxes_xyxy, valid=None,
                   masks=None):
            updates.append((np.array(image_ids), np.array(valid),
                            np.array(scores), np.array(boxes_xyxy)))
            super().update(image_ids, scores, boxes_xyxy, valid, masks)

    monkeypatch.setattr(engine, "TaskEvaluator", Recording)
    Q = 7

    def step(batch):
        ids = torch.from_numpy(batch["image_id"]).to(cuda, torch.float32)
        torch.cuda._sleep(50_000_000)        # ~25 ms: the copies queue up
        q = torch.arange(Q, device=cuda, dtype=torch.float32)
        boxes = torch.stack([ids[:, None] + q, ids[:, None] * 2 + q,
                             ids[:, None] * 3 + q, ids[:, None] * 4 + q],
                            -1) * 10.0
        return {"post": {"scores": (ids[:, None] + q) / 1024.0,
                         "boxes": boxes},
                "scalars": {"loss": ids.sum()}}

    engine.evaluate(step, sets, spec, batch_size=3)
    assert len(updates) == 4
    seen = [int(i) for ids, valid, _, _ in updates for i in ids[valid]]
    assert len(seen) == len(set(seen)) == 8          # distinct images
    q = np.arange(Q)
    for ids, _, scores, boxes in updates:
        for r, i in enumerate(ids):
            np.testing.assert_array_equal(scores[r], (i + q) / 1024.0)
            for c, m in enumerate((1, 2, 3, 4)):
                np.testing.assert_array_equal(boxes[r, :, c],
                                              (i * m + q) * 10.0)


def _cluster_case(seed=0, B=3, S_img=40, T=16, D=256, N=4):
    rng = np.random.default_rng(seed)
    tm = rng.normal(size=(B, T, D)).astype(np.float32)
    mem = np.concatenate([rng.normal(size=(B, S_img, D)), tm], 1)
    spans = np.full((B, N, 2), -1, np.int32)
    spans[:2, :2] = [3, 4]
    bv = np.zeros((B, N), bool)
    bv[:2, :2] = True
    batch = {"noun_token_spans": spans, "box_valid": bv,
             "caption_noun_span": np.array([[3, 4], [5, 5], [2, 6]],
                                           np.int32),
             "sample_valid": np.array([True, True, False]),
             "task_id": np.array([1, 1, 0], np.int32)}
    cache = {"text_memory": tm, "img_memory": mem.astype(np.float32)}
    return cache, batch


def test_cluster_bank_on_the_card_matches_the_cpu_without_a_sync(cuda):
    """The bank update, the k-means and the snapping at the distillation
    shapes (a [14, 1024, 256] bank, K 3, 32 iterations) queue on the card
    with no host sync (set_sync_debug_mode "error" raises on one) and give
    the CPU's centers within 1e-4 and its choices."""
    from toist_tpu_torch.train import cluster as cl

    cache, batch = _cluster_case()
    bank = cl.init_bank(14, 1024, 3, 256, torch.Generator().manual_seed(0))
    results = {}
    for dev in ("cpu", "cuda"):
        b = cl.ClusterBank(**{k: v.to(dev) for k, v in vars(bank).items()})
        c = {k: torch.from_numpy(v).to(dev) for k, v in cache.items()}
        x = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            b, t_mod, t_aux = cl.teacher_update_and_snap(b, c, x, 32)
            b, s_mod, s_aux = cl.student_cluster(b, c, x, 32, train=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        results[dev] = (b, t_mod, s_mod, t_aux["choices"], s_aux["choices"],
                        s_aux["loss_cluster_feature"])
    cpu, gpu = results["cpu"], results["cuda"]
    for k in ("update_count", "full"):
        assert torch.equal(getattr(cpu[0], k), getattr(gpu[0], k).cpu()), k
    for k in ("feature_bank", "cluster_centers"):   # f32 sums, other order
        torch.testing.assert_close(getattr(gpu[0], k).cpu(),
                                   getattr(cpu[0], k), atol=1e-4, rtol=1e-4)
    for a, b in zip(cpu[1:3], gpu[1:3]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    assert torch.equal(cpu[3], gpu[3].cpu()) and torch.equal(cpu[4],
                                                            gpu[4].cpu())
    torch.testing.assert_close(gpu[5].cpu(), cpu[5], rtol=1e-4, atol=0)


def test_softkd_on_the_card_launches_the_lsa_kernel(cuda):
    """All decoder levels' softkd re-pairing in one solve of [L*B, 100,
    100]: one LSA kernel launch, the CPU's loss (plain solver) within
    1e-5."""
    from toist_tpu_torch.train.criterion import loss_softkd_levels

    rng = np.random.default_rng(1)
    L, B, Q, N = 6, 3, 100, 25
    logits = rng.normal(size=(2, L, B, Q, 256)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (2, L, B, Q, 2)),
                            rng.uniform(0.05, 0.4, (2, L, B, Q, 2))], -1)
    bv = np.zeros((B, N), bool)
    bv[:, :3] = True
    t2q = np.stack([np.stack([np.stack([np.where(
        bv[b], rng.permutation(Q)[:N], -1) for b in range(B)])
        for _ in range(L)]) for _ in range(2)]).astype(np.int32)
    args = [logits[0], logits[1], boxes[0].astype(np.float32),
            boxes[1].astype(np.float32), t2q[0], t2q[1], bv,
            np.ones(B, bool)]
    want = loss_softkd_levels(*(torch.from_numpy(a) for a in args))
    before = solve_lsa_batch.launches
    got = loss_softkd_levels(*(torch.from_numpy(a).cuda() for a in args))
    assert solve_lsa_batch.launches - before == 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-7)


def test_mask_postprocess_on_the_card_matches_the_cpu(cuda):
    """The device mask postprocess on CUDA logits against the same function
    on the same logits on the CPU (the cases of tests/seg_cases.py: the
    transitions path, the packed path, mixed, an invalid sample, an
    original over 640x640): equal RLEs except at knife-edge pixels;
    "device_ms" from CUDA events."""
    from seg_cases import assert_rles_agree, postprocess_case
    from toist_tpu_torch.models.postprocess import postprocess_masks_device

    for case in ("blobs", "salt", "mixed", "invalid", "oversized"):
        logits, sizes, orig, valid = postprocess_case(case)
        want = postprocess_masks_device(torch.from_numpy(logits), sizes,
                                        orig, valid)
        timings = {}
        got = postprocess_masks_device(torch.from_numpy(logits).cuda(),
                                       sizes, orig, valid, timings=timings)
        assert_rles_agree(got, want, logits, sizes, orig, valid)
        assert timings["device_ms"] > 0, case


def test_frozen_detector_step_launches_no_attention_backward(cuda):
    """One bf16 train step of a 6+6-layer seg model under frozen_detector
    at a canvas whose joint sequence reaches the kernels: 12 tensor-core
    forwards with dropout, no dK/dV or dQ launch, one LSA; only the mask
    branch trains (its f32 masters move: one AdamW step is below a bf16
    ulp of a GroupNorm scale of 1), the detector stays bit for bit."""
    from seg_cases import VOCAB, seg_batch
    from toist_tpu_torch.config import Config
    from toist_tpu_torch.models.init import init_like_jax
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.train.criterion import build_weight_dict
    from toist_tpu_torch.train.state import init_train_state, model_masters
    from toist_tpu_torch.train.step import make_train_step

    cfg = Config.from_sources(None, {
        "model": {"backbone": "resnet18-test", "hidden_dim": 128,
                  "nheads": 8, "dim_feedforward": 128, "num_queries": 8,
                  "contrastive_align_loss": False,
                  "mask_model": "smallconv", "frozen_detector": True,
                  "text_hidden": 64, "text_layers": 1, "text_heads": 4,
                  "text_intermediate": 128},
        "loss": {"aux_loss": False}})
    assert cfg.model.dropout == 0.1 and cfg.model.enc_layers == 6
    with torch.device("cuda"):
        model = TOIST(cfg.model, text_vocab_size=VOCAB)
    init_like_jax(model, torch.Generator("cuda").manual_seed(0))
    model.to_compute_dtype()
    state = init_train_state(model, cfg, 10, 100)
    batch = seg_batch()
    pad = {"images": ((0, 0), (0, 384), (0, 512), (0, 0)),
           "image_mask": ((0, 0), (0, 384), (0, 512)),
           "gt_masks": ((0, 0), (0, 0), (0, 96), (0, 128))}
    for k, p in pad.items():                    # a 480x640 canvas
        batch[k] = np.pad(batch[k], p, constant_values=k == "image_mask")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    masters = {n: m.detach().clone() for n, _, m in model_masters(state)}
    assert {n.split(".")[0] for n in masters} == {"bbox_attention",
                                                  "mask_head"}
    counts = ("launches", "fwd_tc_launches", "dkv_launches", "dq_launches",
              "dropout_launches")
    c0 = [getattr(flash_attention, c) for c in counts]
    l0 = solve_lsa_batch.launches
    state, sc = make_train_step(cfg, build_weight_dict(cfg.loss, True,
                                                       6))(state, batch)
    torch.cuda.synchronize()
    got = [getattr(flash_attention, c) - v for c, v in zip(counts, c0)]
    assert got == [12, 12, 0, 0, 12]
    assert solve_lsa_batch.launches - l0 == 1
    assert torch.isfinite(sc["loss_mask"]) and torch.isfinite(
        sc["loss_dice"])
    for n, _, m in model_masters(state):
        assert not torch.equal(m, masters[n]), n
    for n, p in model.named_parameters():
        if n not in masters:
            assert torch.equal(p, before[n]), n


@pytest.mark.parametrize("fused", ["off", "auto"])
def test_fused_attention_off_routes_around_the_kernels(cuda, tmp_path,
                                                       fused):
    """model.fused_attention="off" on the card: no kernel launch, the
    plain version throughout; "auto": the kernels (2 encoder self- and 2
    decoder cross-attentions per forward)."""
    import dataclasses

    from toist_tpu_torch import infer
    from toist_tpu_torch.models.toist import TOIST

    cfg, sets, spec, sd = _tiny_eval_setup(tmp_path, "bfloat16")
    mcfg = dataclasses.replace(cfg.model, fused_attention=fused)
    model = TOIST.from_state_dict(sd, mcfg, device="cuda")
    from toist_tpu_torch.data.batcher import BatchIterator
    batch = next(BatchIterator([sets[1]], spec, batch_size=2,
                               shuffle=False).epoch(0))
    before = flash_attention.launches
    out, _ = infer.forward(model, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(out["pred_logits"]).all()
    assert flash_attention.launches - before == (0 if fused == "off" else 4)


# The Predictor's CUDA graphs of the image and text encoders
# (predict.UnimodalGraphs): every replay bit for bit equal to the eager
# forward of the same model, on the serving canvases, one capture per key.

def _flagship_state(seed):
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


@pytest.fixture(scope="module")
def flagship():
    """The flagship (ResNet-101, RoBERTa-base, bf16) as a Predictor on the
    card, from seeded weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from toist_tpu_torch.config import Config
    from toist_tpu_torch.predict import Predictor

    cfg = Config.from_sources(None, {"run": {"compute_eval_losses": False}})
    return Predictor.from_state_dict(_flagship_state(0), cfg)


def _serving_batch(predictor, rng, n, orient="landscape", rows=None,
                   size=None):
    """``n`` images of ``size``, or resized to a short side of 800 (long
    side 900-1333, landscape or portrait), collated on their canvas in a
    batch of ``rows`` (default ``n``)."""
    from toist_tpu_torch.data.batcher import collate

    samples = []
    for i in range(n):
        long_ = int(rng.integers(900, 1334))
        hw = size or ((800, long_) if orient == "landscape" else (long_, 800))
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        samples.append(predictor.prepare(img, int(1 + (i * 5) % 14)))
    return collate(samples, predictor.spec, predictor.bucket(samples[0]),
                   batch_size=rows or n)


def _assert_replay_is_eager(model, graphs, batch):
    """The forward with the encoders replayed equals the eager one bit for
    bit: every output and the postprocessed detections. Returns them."""
    from toist_tpu_torch import infer

    want, x = infer.forward(model, batch)
    want_post = infer.postprocess(want, x)
    got, x = infer.forward(model, batch, unimodal=graphs)
    got_post = infer.postprocess(got, x)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    for k, w in want_post.items():
        assert torch.equal(got_post[k], w), k
    return got, got_post


def test_replay_matches_eager_with_canvases_alternating(cuda, flagship):
    from toist_tpu_torch.predict import UnimodalGraphs

    graphs = UnimodalGraphs(flagship.model)
    rng = np.random.default_rng(0)
    batches = {(n, o): _serving_batch(flagship, rng, n, o)
               for n in (1, 8) for o in ("landscape", "portrait")}
    assert {tuple(b["images"].shape[1:3]) for b in batches.values()} == {
        (800, 1344), (1344, 800)}
    order = [(1, "landscape"), (1, "portrait"), (8, "landscape"),
             (8, "portrait"), (1, "landscape"), (8, "portrait"),
             (1, "portrait"), (8, "landscape"), (1, "landscape"),
             (1, "portrait"), (8, "landscape"), (8, "portrait")]
    seen = set()
    for key in order:
        before = (graphs.captures, graphs.replays)
        _assert_replay_is_eager(flagship.model, graphs, batches[key])
        new = key not in seen
        seen.add(key)
        assert (graphs.captures, graphs.replays) == (
            before[0] + new, before[1] + (not new)), key
    assert (graphs.captures, graphs.replays, graphs.eager) == (
        4, len(order) - 4, 0)
    assert len(graphs.by_key) == 4


def test_replay_matches_eager_half_empty_and_after_new_weights(cuda,
                                                               flagship):
    from toist_tpu_torch.predict import UnimodalGraphs

    model = flagship.model
    graphs = UnimodalGraphs(model)
    rng = np.random.default_rng(1)
    full = _serving_batch(flagship, rng, 8, "landscape")
    half = _serving_batch(flagship, rng, 3, "landscape", rows=8)
    assert full["images"].shape == half["images"].shape
    assert int(half["sample_valid"].sum()) == 3
    _, before = _assert_replay_is_eager(model, graphs, full)
    _assert_replay_is_eager(model, graphs, half)
    assert (graphs.captures, graphs.replays) == (1, 1)

    old = {k: v.clone() for k, v in model.state_dict().items()}
    new = {k: v * 0.9 if v.is_floating_point() else v
           for k, v in old.items()}
    try:
        model.load_state_dict(new)       # in place: the graphs see it
        _, after = _assert_replay_is_eager(model, graphs, full)
        assert not torch.equal(after["scores"], before["scores"])
        assert (graphs.captures, graphs.replays) == (1, 2)
    finally:
        model.load_state_dict(old)
    _, again = _assert_replay_is_eager(model, graphs, full)
    assert torch.equal(again["scores"], before["scores"])

    # The Predictor's own calls replay its graphs after the first.
    flagship.predict_batch(full)
    n = flagship.graphs.captures
    for _ in range(2):
        flagship.predict_batch(full)
    assert flagship.graphs.captures == n and flagship.graphs.eager == 0


def test_replay_matches_eager_with_a_mask_head(cuda):
    """The mask head reads the backbone's features from the graph's
    outputs (``features_c2..c4``, ``src_proj``, ``feature_mask``)."""
    from toist_tpu_torch.config import Config
    from toist_tpu_torch.data.captions import build_tokenizer
    from toist_tpu_torch.predict import Predictor, UnimodalGraphs
    from toist_tpu_torch.utils.convert import synth_reference_state_dict

    cfg = Config.from_sources(None, {
        "model": {"backbone": "resnet18-test", "hidden_dim": 128,
                  "nheads": 8, "dim_feedforward": 256, "enc_layers": 2,
                  "dec_layers": 2, "num_queries": 10, "text_hidden": 64,
                  "text_layers": 2, "text_heads": 4, "text_intermediate": 128,
                  "contrastive_hdim": 16, "mask_model": "smallconv"},
        "data": {"image_buckets": [[320, 448], [448, 320]],
                 "max_text_len": 64, "max_size": 448, "val_size": 320}})
    assert cfg.model.masks
    tok = build_tokenizer(cfg)
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=2, dec=2, d=128, dim_feedforward=256,
        text_layers=2, text_hidden=64, text_intermediate=128, num_queries=10,
        vocab_size=tok.vocab_size, contrastive_hdim=16, with_masks=True,
        seed=7)
    predictor = Predictor.from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg, tokenizer=tok)
    graphs = UnimodalGraphs(predictor.model)
    rng = np.random.default_rng(2)
    batches = [_serving_batch(predictor, rng, 2, size=size)
               for size in ((320, 440), (440, 320))]
    for b in batches + batches + batches:
        got, _ = _assert_replay_is_eager(predictor.model, graphs, b)
        assert got["pred_masks"].shape[:2] == (2, 10)
    assert (graphs.captures, graphs.replays) == (2, 4)
    res = predictor.predict_batch(batches[0])
    assert len(res) == 2 and all("masks" in r for r in res)


# The frozen-norm epilogue kernel (ops/frozen_norm.py,
# csrc/frozen_norm_act.cu): against the same formula in f32 on the card
# (the kernel sums in f32 in the modules' order and rounds once: within one
# bf16 rounding), and against the plain route, the modules on the same
# tensors: in f32 bit for bit, forward and backward; in bf16, where the
# plain route rounds scale, shift and each partial result, within REL of
# the output's max abs. Backward inputs are drawn 0.1 or more from the
# ReLU's kink, so that both routes agree on its side.

FN_FORMS = ["relu", "residual", "downsample"]


def _fn_norm(c, g, dtype):
    from toist_tpu_torch.models.resnet import FrozenBatchNorm2d

    n = FrozenBatchNorm2d(c)
    n.weight.copy_(torch.rand(c, generator=g) + 0.5)
    n.bias.copy_(torch.randn(c, generator=g) * 0.3)
    n.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
    n.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.1)
    return n.to("cuda", dtype)


def _fn_scale_shift(n):
    s = n.weight.float() / torch.sqrt(n.running_var.float() + n.eps)
    return (s[None, :, None, None],
            (n.bias.float() - n.running_mean.float() * s)[None, :, None,
                                                           None])


def _fn_case(form, dtype, h, w, mask_stride, seed=0, away=False):
    """z, the residual or the downsample pair, the norms and the pad mask of
    one case, channels-last on the card. With ``away`` z is drawn so that
    the pre-activation lies 0.1-2 from 0 on either side."""
    g = torch.Generator().manual_seed(seed)
    c = 64 if form == "relu" else 256
    shape = (2, c, h, w)
    bn, bn_ds = _fn_norm(c, g, dtype), _fn_norm(c, g, dtype)
    other = torch.randn(shape, generator=g).clamp(-1, 1)
    s, b = (t.cpu() for t in _fn_scale_shift(bn))
    add = 0.0
    if form == "residual":
        add = other.to(dtype).float()
    elif form == "downsample":
        sd, bd = (t.cpu() for t in _fn_scale_shift(bn_ds))
        add = other.to(dtype).float() * sd + bd
    if away:
        sign = torch.where(torch.rand(shape, generator=g) < 0.5, -1.0, 1.0)
        pre = sign * (0.1 + 1.9 * torch.rand(shape, generator=g))
        z = (pre - b - add) / s
    else:
        z = torch.randn(shape, generator=g) * 2
    cl = torch.channels_last
    z = z.to("cuda", dtype).contiguous(memory_format=cl)
    other = other.to("cuda", dtype).contiguous(memory_format=cl)
    mask = None
    if mask_stride:
        mask = torch.zeros(2, h * mask_stride, w * mask_stride,
                           dtype=torch.bool)
        mask[1, (h * mask_stride * 2) // 3:] = True
        mask[1, :, (w * mask_stride) // 2:] = True
        mask[0, :, w * mask_stride - 1] = True
        mask = mask.cuda()
    return z, other, bn, bn_ds, mask


def _fn_args(form, other, bn_ds):
    if form == "residual":
        return {"residual": other}
    if form == "downsample":
        return {"downsample": (other, bn_ds)}
    return {}


def _fn_f32(z, form, other, bn, bn_ds, mask):
    """The formula in f32: relu(z s + b (+ r | + z_ds s_ds + b_ds)) keep."""
    s, b = _fn_scale_shift(bn)
    v = z.float() * s + b
    if form == "residual":
        v = v + other.float()
    elif form == "downsample":
        sd, bd = _fn_scale_shift(bn_ds)
        v = v + (other.float() * sd + bd)
    v = torch.relu(v)
    if mask is not None:
        from toist_tpu_torch.ops.frozen_norm import downsample_mask

        keep = ~downsample_mask(mask, v.shape[2], v.shape[3])
        v = v * keep[:, None].float()
    return v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", FN_FORMS)
@pytest.mark.parametrize("mask_stride", [0, 4, 32])
@pytest.mark.parametrize("h,w", [(13, 11), (24, 40)])
def test_frozen_norm_kernel_matches_f32_and_plain(cuda, dtype, form,
                                                  mask_stride, h, w):
    from toist_tpu_torch.ops.frozen_norm import frozen_norm, frozen_norm_plain

    z, other, bn, bn_ds, mask = _fn_case(form, dtype, h, w, mask_stride)
    kw = _fn_args(form, other, bn_ds)
    before = (frozen_norm.launches, frozen_norm.plain)
    with torch.no_grad():
        y = frozen_norm(z, bn, pad_mask=mask, **kw)
        torch.cuda.synchronize()
        assert (frozen_norm.launches, frozen_norm.plain) == (
            before[0] + 1, before[1])
        assert y.dtype == dtype and y.is_contiguous(
            memory_format=torch.channels_last)
        want = _fn_f32(z, form, other, bn, bn_ds, mask)
        rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
        torch.testing.assert_close(y.float(), want, rtol=rtol, atol=0.0)
        plain = frozen_norm_plain(z, bn, kw.get("residual"),
                                  kw.get("downsample"), mask)
        if dtype == torch.float32:
            assert torch.equal(y, plain)
        else:
            _close(y, plain, REL[dtype])
    if mask is not None:
        from toist_tpu_torch.ops.frozen_norm import downsample_mask

        pad = downsample_mask(mask, h, w)
        assert (y.permute(0, 2, 3, 1)[pad] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", FN_FORMS)
@pytest.mark.parametrize("mask_stride", [0, 4])
def test_frozen_norm_backward_matches_plain(cuda, dtype, form, mask_stride):
    from toist_tpu_torch.ops.frozen_norm import frozen_norm, frozen_norm_plain

    z, other, bn, bn_ds, mask = _fn_case(form, dtype, 13, 11, mask_stride,
                                         seed=1, away=True)
    gw = torch.randn(z.shape, generator=torch.Generator().manual_seed(2))
    gw = gw.to("cuda", dtype)

    def run(fn):
        zz = z.detach().requires_grad_()
        oo = other.detach().requires_grad_()
        kw = _fn_args(form, oo, bn_ds)
        y = fn(zz, bn, kw.get("residual"), kw.get("downsample"), mask)
        dz, do = torch.autograd.grad(y, (zz, oo), gw, allow_unused=True)
        return y.detach(), dz, do

    before = frozen_norm.bwd_launches
    y, dz, do = run(lambda *a: frozen_norm(a[0], a[1], residual=a[2],
                                           downsample=a[3], pad_mask=a[4]))
    torch.cuda.synchronize()
    assert frozen_norm.bwd_launches == before + 1
    py, pdz, pdo = run(frozen_norm_plain)
    assert torch.equal(y > 0, py > 0)        # the kink is not in play
    f32 = dtype == torch.float32
    rtol = 0.0 if f32 else 2.0 ** -7
    torch.testing.assert_close(dz, pdz, rtol=rtol, atol=0)
    # Against the formula in f32 from the kernel's own output.
    s, _ = _fn_scale_shift(bn)
    live = (y > 0).float()
    torch.testing.assert_close(dz.float(), gw.float() * live * s,
                               rtol=0.0 if f32 else 2.0 ** -8, atol=0)
    if form == "relu":
        assert do is None and pdo is None
    elif form == "residual":
        assert torch.equal(do, pdo)            # g [y > 0]: exact
    else:
        torch.testing.assert_close(do, pdo, rtol=rtol, atol=0)
        sd, _ = _fn_scale_shift(bn_ds)
        torch.testing.assert_close(do.float(), gw.float() * live * sd,
                                   rtol=0.0 if f32 else 2.0 ** -8, atol=0)


def test_frozen_norm_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    from toist_tpu_torch.ops.frozen_norm import frozen_norm

    z, other, bn, bn_ds, mask = _fn_case("residual", torch.bfloat16, 8, 8, 4)
    with pytest.raises(ValueError, match="channels-last"):
        frozen_norm(z.contiguous(), bn)
    with pytest.raises(ValueError, match="channels-last"):
        frozen_norm(z, bn, residual=other.contiguous())
    with pytest.raises(TypeError):
        frozen_norm(z.half(), bn)
    with pytest.raises(ValueError, match="pad_mask"):
        frozen_norm(z, bn, pad_mask=mask.cpu())
    with pytest.raises(ValueError, match="buffers"):
        frozen_norm(z, bn.cpu())


def test_resnet101_forward_takes_the_kernel_at_every_norm(cuda,
                                                          monkeypatch):
    """One bf16 ResNet-101 forward: 100 kernel launches (the stem and 33
    blocks x 3) and no plain call; its backward 100 backward launches. In
    f32 the features equal the plain route's bit for bit."""
    import toist_tpu_torch.models.resnet as resnet_mod
    from toist_tpu_torch.ops.frozen_norm import frozen_norm, frozen_norm_plain

    torch.manual_seed(0)
    cl = torch.channels_last
    net = resnet_mod.Backbone("resnet101").to(
        "cuda", torch.bfloat16).to(memory_format=cl)
    x32 = torch.randn(2, 3, 160, 224, device="cuda")
    mask = torch.zeros(2, 160, 224, dtype=torch.bool, device="cuda")
    mask[1, 96:] = True
    x = x32.to(torch.bfloat16).contiguous(memory_format=cl)
    x.requires_grad_()
    before = (frozen_norm.launches, frozen_norm.plain,
              frozen_norm.bwd_launches)
    feats = net(x, mask)
    assert (frozen_norm.launches - before[0],
            frozen_norm.plain - before[1]) == (100, 0)
    sum(f.float().sum() for f in feats.values()).backward()
    torch.cuda.synchronize()
    assert frozen_norm.bwd_launches - before[2] == 100

    net = net.float()
    x = x32.contiguous(memory_format=cl)
    with torch.no_grad():
        got = net(x, mask)
        monkeypatch.setattr(
            resnet_mod, "frozen_norm",
            lambda z, norm, residual=None, downsample=None, pad_mask=None:
            frozen_norm_plain(z, norm, residual, downsample, pad_mask))
        want = net(x, mask)
    for k, f in got.items():
        assert torch.isfinite(f).all()
        assert torch.equal(f, want[k]), k


def test_replay_matches_eager_after_new_norm_buffers(cuda, flagship):
    """The kernel reads the norms' buffers at every launch, so a replay
    after an in-place load_state_dict that changes every norm's buffers
    equals the eager forward with the new buffers."""
    from toist_tpu_torch.models.resnet import FrozenBatchNorm2d
    from toist_tpu_torch.predict import UnimodalGraphs

    model = flagship.model
    graphs = UnimodalGraphs(model)
    rng = np.random.default_rng(3)
    batch = _serving_batch(flagship, rng, 8, "landscape")
    _, before = _assert_replay_is_eager(model, graphs, batch)
    norms = [n for n, m in model.named_modules()
             if isinstance(m, FrozenBatchNorm2d)]
    assert len(norms) == 104
    old = {k: v.clone() for k, v in model.state_dict().items()}
    new = dict(old)
    g = torch.Generator().manual_seed(4)
    for n in norms:
        for b, lo, hi in (("weight", 0.7, 1.3), ("bias", -0.1, 0.1),
                          ("running_mean", -0.1, 0.1),
                          ("running_var", 0.8, 1.5)):
            k = f"{n}.{b}"
            u = torch.rand(old[k].shape, generator=g) * (hi - lo) + lo
            u = u.to(old[k].device, old[k].dtype)
            new[k] = old[k] * u if b in ("weight", "running_var") \
                else old[k] + u
    try:
        model.load_state_dict(new)       # in place: the graph sees it
        _, after = _assert_replay_is_eager(model, graphs, batch)
        assert not torch.equal(after["scores"], before["scores"])
        assert (graphs.captures, graphs.replays) == (1, 1)
    finally:
        model.load_state_dict(old)
    _, again = _assert_replay_is_eager(model, graphs, batch)
    assert torch.equal(again["scores"], before["scores"])
