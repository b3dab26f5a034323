"""The port's segmentation slice against the JAX package on the CPU.

The model is tests/test_segmentation.py's SEG_CFG (hidden 128, 8 heads,
1+1 layers, resnet18-test, 8 queries) with a frozen-BN backbone, on
96x128 canvases; its weights are one reference-layout state dict
(``synth_reference_state_dict(with_masks=True)``), which the JAX side reads
through ``convert_torch_state_dict`` and the port gets back through
``jax_params_to_state_dict``. Tolerances: ``MHAttentionMap`` 1e-5
(probabilities); ``MaskHeadSmallConv`` 1e-4 and ``compute_masks`` 2e-3 of
the output's max abs; the focal, dice and mask losses 1e-5 relative; one
f32 frozen-detector train step: losses 1e-4 relative and the mask branch's
gradients 2e-3 of each tensor's max abs. The mask postprocess gives the
JAX package's RLEs, except at knife-edge pixels: a pixel may differ only
where its interpolated logit, recomputed in float64, lies within 1e-5 of
the threshold.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toist_tpu.config import Config, ModelConfig
from toist_tpu.models import postprocess as jpost
from toist_tpu.models import segmentation as jseg
from toist_tpu.models.toist import build_model
from toist_tpu.train import criterion as jcrit
from toist_tpu.train import optim as joptim
from toist_tpu.train.state import TrainState
from toist_tpu.train.step import make_train_step as jax_make_train_step
from toist_tpu.utils.convert import (convert_torch_state_dict,
                                     synth_reference_state_dict)
from toist_tpu_torch import config as pconfig
from toist_tpu_torch.models import postprocess as ppost
from toist_tpu_torch.models import segmentation as pseg
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.train import criterion as pcrit
from toist_tpu_torch.train import optim as poptim
from toist_tpu_torch.train.state import init_train_state
from toist_tpu_torch.train.step import accumulate_gradients, make_train_step
from toist_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.seg_cases import (B, KNIFE, VOCAB, assert_rles_agree, interp64,
                             postprocess_case, seg_batch)

SEG = ModelConfig(backbone="resnet18-test", hidden_dim=128, nheads=8,
                  dim_feedforward=128, enc_layers=1, dec_layers=1,
                  num_queries=8, compute_dtype="float32",
                  contrastive_align_loss=False, mask_model="smallconv",
                  masks=True, backbone_norm="frozen_bn", text_hidden=64,
                  text_layers=1, text_heads=4, text_intermediate=128,
                  dropout=0.0, resizer_dropout=0.0, fused_attention="off")
TOL = 2e-3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pcfg(mcfg):
    return pconfig.ModelConfig(**dataclasses.asdict(mcfg))


def _state_dict(contrastive_loss=False, seed=4):
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=1, dec=1, d=128, dim_feedforward=128,
        text_layers=1, text_hidden=64, text_intermediate=128, num_queries=8,
        vocab_size=VOCAB, contrastive=False, with_masks=True, seed=seed)
    if contrastive_loss:
        rng = np.random.default_rng(seed + 1)
        sd["transformer.CLS.weight"] = rng.normal(size=(1, 128)).astype(
            np.float32)
        for k, shape in (("weight", (64, 64)), ("bias", (64,))):
            sd[f"transformer.text_encoder.pooler.dense.{k}"] = rng.normal(
                scale=0.125, size=shape).astype(np.float32)
    return sd


INPUT_KEYS = ("images", "image_mask", "text_ids", "text_mask")


class _Pair:
    """One weight set in both packages, and each side's cache and decoder
    output on ``seg_batch()``."""

    def __init__(self, mcfg):
        self.mcfg = mcfg
        self.sd = _state_dict(mcfg.contrastive_loss)
        self.params, self.frozen = convert_torch_state_dict(
            self.sd, d_model=128, enc_layers=1, dec_layers=1,
            stage_sizes=(1, 1, 1, 1), with_masks=True)
        self.variables = {"params": self.params, **self.frozen}
        self.jmodel = build_model(mcfg, text_vocab_size=VOCAB)
        self.psd = jax_params_to_state_dict(self.params, self.frozen)
        self.port = TOIST.from_state_dict(self.psd, _pcfg(mcfg),
                                          device="cpu")
        batch = seg_batch()
        jm = self.jmodel
        self.jout, self.jcache = jax.jit(lambda v, *a: jm.apply(v, *a))(
            self.variables, *(batch[k] for k in INPUT_KEYS))
        with torch.inference_mode():
            self.out, self.cache = self.port(
                *(_t(batch[k]) for k in INPUT_KEYS))

    def jax_masks(self, query_idx, layout="flat"):
        m = self.jmodel if layout == "flat" else build_model(
            dataclasses.replace(self.mcfg, mask_head_layout=layout),
            text_vocab_size=VOCAB)
        return np.asarray(jax.jit(lambda v, c, h, i: m.apply(
            v, c, h, i, method=m.compute_masks))(
                self.variables, self.jcache, self.jout["hs"][-1], query_idx))


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, contrastive_loss):
    if contrastive_loss not in pairs:
        pairs[contrastive_loss] = _Pair(dataclasses.replace(
            SEG, contrastive_loss=contrastive_loss))
    return pairs[contrastive_loss]


def test_mh_attention_map_matches_jax():
    """A padded and a fully padded sample (uniform maps, not NaN)."""
    rng = np.random.default_rng(0)
    D, nh = 128, 8
    wq, wk = (rng.normal(scale=D ** -0.5, size=(D, D)).astype(np.float32)
              for _ in range(2))
    bq, bk = (rng.normal(scale=0.1, size=(D,)).astype(np.float32)
              for _ in range(2))
    q = rng.normal(size=(2, 5, D)).astype(np.float32)
    k = rng.normal(size=(2, 3, 4, D)).astype(np.float32)
    pad = np.zeros((2, 3, 4), bool)
    pad[0, 2:] = True
    pad[0, :, 3] = True
    pad[1] = True
    jparams = {"params": {"q_linear": {"kernel": wq.T, "bias": bq},
                          "k_linear": {"kernel": wk.T, "bias": bk}}}
    want = jseg.MHAttentionMap(D, nh).apply(jparams, q, k, pad)
    mod = pseg.MHAttentionMap(D, nh)
    mod.load_state_dict({"q_linear.weight": _t(wq), "q_linear.bias": _t(bq),
                         "k_linear.weight": _t(wk), "k_linear.bias": _t(bk)})
    with torch.no_grad():
        got = mod(_t(q), _t(k), _t(pad)).numpy()
    assert got.shape == (2, 5, nh, 3, 4)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got[1], 1.0 / 12, atol=1e-6)
    assert (got[0][..., 2:, :] < 1e-6).all()


def test_mask_head_matches_jax(pairs):
    pair = _pair(pairs, False)
    rng = np.random.default_rng(1)
    n = 3
    x = rng.normal(size=(B * n, 3, 4, 136)).astype(np.float32)
    feats = [rng.normal(size=(B, 3 * f, 4 * f, c)).astype(np.float32)
             for f, c in ((2, 1024), (4, 512), (8, 256))]
    want = np.asarray(jax.jit(lambda p, *a: jseg.MaskHeadSmallConv(
        136, 128).apply({"params": p}, *a, num_queries=n))(
            pair.params["mask_head"], x, *feats))
    with torch.no_grad():
        got = pair.port.mask_head(
            *(_t(a).permute(0, 3, 1, 2) for a in [x] + feats),
            num_queries=n).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (B * n, 24, 32, 1)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    # The (608, 1008) training rung: 32 columns at stride 32, 63 at 16 (the
    # JAX head's integer repeat cannot reach 63; nearest as the reference).
    with torch.no_grad():
        wide = pair.port.mask_head(
            torch.zeros(B * n, 136, 1, 32), torch.zeros(B, 1024, 2, 63),
            torch.zeros(B, 512, 4, 126), torch.zeros(B, 256, 8, 252),
            num_queries=n)
    assert wide.shape == (B * n, 1, 8, 252)


@pytest.mark.parametrize("case", ["all", "subset", "contrastive_loss",
                                  "folded"])
def test_compute_masks_matches_jax(pairs, case):
    """All queries, a query_idx subset (clipped -1 included), the CLS slot
    of contrastive_loss, and a folded-layout JAX model against the port's
    flat head on the same parameters."""
    pair = _pair(pairs, case == "contrastive_loss")
    idx = None
    if case in ("subset", "folded"):
        idx = np.asarray([[2, 5, -1, 0], [7, 3, 3, 1]], np.int32)
    want = pair.jax_masks(None if idx is None else jnp.asarray(idx),
                          "folded" if case == "folded" else "flat")
    with torch.inference_mode():
        got = pair.port.compute_masks(
            pair.cache, pair.out["hs"][-1],
            None if idx is None else _t(idx)).numpy()
    assert got.dtype == np.float32
    assert got.shape == want.shape == (B, 8 if idx is None else 4, 24, 32)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())
    for key in ("pred_logits", "pred_boxes", "hs"):
        np.testing.assert_allclose(pair.out[key].numpy(),
                                   np.asarray(pair.jout[key]), atol=TOL)


@pytest.mark.parametrize("override", [None, 2.5])
def test_mask_losses_match_jax(override):
    rng = np.random.default_rng(2)
    logits = (3 * rng.normal(size=(3, 4, 12, 10))).astype(np.float32)
    gt = (rng.uniform(size=(3, 4, 12, 10)) < 0.3).astype(np.uint8)
    bv = np.array([[1, 1, 0, 1], [0, 0, 0, 0], [1, 0, 0, 0]], bool)
    sv = np.array([True, True, False])
    nb = None if override is None else np.float32(override)
    want = jcrit.mask_losses(jnp.asarray(logits), jnp.asarray(gt),
                             jnp.asarray(bv), jnp.asarray(sv),
                             num_boxes=None if nb is None else jnp.asarray(nb))
    got = pcrit.mask_losses(_t(logits), _t(gt), _t(bv), _t(sv),
                            num_boxes=None if nb is None else torch.tensor(nb))
    assert set(got) == set(want) == {"loss_mask", "loss_dice"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    src, tgt = logits.reshape(3, 4, -1), gt.reshape(3, 4, -1).astype(
        np.float32)
    v = (bv & sv[:, None]).astype(np.float32)
    n = np.float32(3.0 if nb is None else nb)
    for fn in ("sigmoid_focal_loss", "dice_loss"):
        np.testing.assert_allclose(
            float(getattr(pcrit, fn)(_t(src), _t(tgt), _t(v),
                                     torch.tensor(n))),
            float(getattr(jcrit, fn)(jnp.asarray(src), jnp.asarray(tgt),
                                     jnp.asarray(v), jnp.asarray(n))),
            rtol=1e-5)


def _grads_as_state():
    """An optax transform whose state after an update is the gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def test_frozen_detector_train_step_matches_jax(pairs):
    """One f32 seg train step at dropout 0 under frozen_detector: JAX
    ``make_train_step(with_masks=True)`` (the gradient read from an
    optimizer that keeps it) against the port's: losses, the mask branch's
    gradients, the trainable set of JAX's ``label_params``, and the frozen
    parameters untouched by a whole step."""
    pair = _pair(pairs, False)
    cfg = Config(model=dataclasses.replace(SEG, frozen_detector=True))
    cfg = dataclasses.replace(cfg, loss=dataclasses.replace(
        cfg.loss, aux_loss=False))
    wd = jcrit.build_weight_dict(cfg.loss, True, 1)
    batch = seg_batch()
    tx = _grads_as_state()
    jstate = TrainState(params=pair.params, opt_state=tx.init(pair.params),
                        ema_params=None, step=jnp.int32(0))
    jstep = jax_make_train_step(pair.jmodel, cfg, wd, tx, pair.frozen,
                                with_masks=True)
    jnew, jsc = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    jgrads = jax_params_to_state_dict(jnew.opt_state, pair.frozen)
    labels = jax.tree_util.tree_leaves_with_path(joptim.label_params(
        pair.params, frozen_detector=True))
    jtrain = {"bbox_attention", "mask_head"} & {
        getattr(path[0], "key", None) for path, lab in labels
        if lab != "frozen"}

    pcfg = pconfig.Config.from_sources(None, {
        "model": dataclasses.asdict(cfg.model), "loss": {"aux_loss": False}})
    model = TOIST.from_state_dict(pair.psd, pcfg.model, device="cpu")
    state = init_train_state(model, pcfg, 10, 100)
    names = dict(model.named_parameters())
    trainable = {n for n, p in names.items() if p.requires_grad}
    assert {n.split(".")[0] for n in trainable} == jtrain
    assert trainable == {n for n, lab in poptim.label_params(
        model, frozen_detector=True).items() if lab != "frozen"}
    scalars = accumulate_gradients(
        state, {k: _t(v) for k, v in batch.items()}, pcfg, wd)
    for k in ("loss_ce", "loss_bbox", "loss_giou", "loss_mask", "loss_dice",
              "loss"):
        np.testing.assert_allclose(float(scalars[k]), float(jsc[k]),
                                   rtol=1e-4, err_msg=k)
    assert len(state.masters) == len(trainable)
    bad = []
    for n in trainable:
        g, want = names[n].grad.numpy(), jgrads[n].numpy()
        if n == "mask_head.lay5.bias":
            # 0 by construction at this width: gn5 has one channel per
            # group, so its mean removes lay5's per-channel bias. Rounding
            # noise on both sides, far below the weight's gradient.
            tol = 1e-4 * np.abs(jgrads["mask_head.lay5.weight"]).max()
            err = max(np.abs(g).max(), np.abs(want).max())
        else:
            tol = TOL * max(np.abs(want).max(), 1e-8)
            err = np.abs(g - want).max()
        if not err <= tol:
            bad.append((n, float(err), float(tol)))
    assert not bad, bad

    model = TOIST.from_state_dict(pair.psd, pcfg.model, device="cpu")
    state = init_train_state(model, pcfg, 10, 100)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, sc = make_train_step(pcfg, wd)(state, batch)
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) != (n in trainable), n
    assert bool(sc["loss_is_finite"]) and state.step == 1


# -- the mask postprocess ----------------------------------------------------

@pytest.mark.parametrize("case", ["blobs", "salt", "mixed", "invalid",
                                  "oversized", "chunked"])
def test_postprocess_masks_device_matches_jax(case, monkeypatch):
    """Blob logits take the transitions path, salt-and-pepper ones overflow
    and take the packed bits (all samples: one whole copy; mixed: per
    sample), and an invalid sample gives None. An original beyond JAX's
    640x640 canvas sends the JAX batch to its PIL host path; the port keeps
    it on the device on a canvas of the batch's largest original. With a
    chunk of one query per pass, the mixed batch gives the same RLEs."""
    if case == "chunked":
        monkeypatch.setattr(ppost, "MAX_CHUNK_PIXELS", 1)
    logits, sizes, orig, valid = postprocess_case(
        "mixed" if case == "chunked" else case)
    want = jpost.postprocess_masks_device(jnp.asarray(logits), sizes, orig,
                                          valid)
    timings = {}
    got = ppost.postprocess_masks_device(_t(logits), sizes, orig, valid,
                                         timings=timings)
    assert_rles_agree(got, want, logits, sizes, orig, valid)
    n_valid = int(valid.sum())
    expect = {"blobs": 0, "salt": n_valid, "mixed": 2, "invalid": 0,
              "oversized": n_valid, "chunked": 2}
    assert timings["n_overflow_samples"] == expect[case]


def _canvas_vectors(sizes, orig, valid):
    """The two-tap vectors of a batch on its canvas (largest original, the
    height rounded up to 8), as start_masks_device builds them."""
    OH = (max(int(o[0]) for o in orig) + 7) // 8 * 8
    OW = max(int(o[1]) for o in orig)
    vec = {k: np.zeros((len(orig), OW if k[1] == "x" else OH),
                       np.float32 if k[0] == "l" else np.int32)
           for k in ("iy0", "iy1", "ly0", "ly1", "ix0", "ix1", "lx0",
                     "lx1")}
    oh_arr, ow_arr = np.ones(len(orig), np.int32), np.zeros(len(orig),
                                                            np.int32)
    for b in range(len(orig)):
        if not valid[b]:
            continue
        oh, ow = map(int, orig[b])
        oh_arr[b], ow_arr[b] = oh, ow
        ch, cw = sizes[b] // 4
        for axis, o, s in (("y", oh, ch), ("x", ow, cw)):
            parts = ppost._interp_vectors(o, s)
            for key, part in zip(("i{}0", "i{}1", "l{}0", "l{}1"), parts):
                vec[key.format(axis)][b, :o] = part
    order = ("iy0", "iy1", "ly0", "ly1", "ix0", "ix1", "lx0", "lx1")
    return [vec[k] for k in order], oh_arr, ow_arr, OH, OW


@pytest.mark.parametrize("case", ["blobs", "mixed"])
def test_device_resize_threshold_matches_jax(case):
    """The device function's four outputs against JAX's on the same
    canvas: the transition counts, positions and overflow flags exactly,
    the packed bits except at knife-edge pixels."""
    logits, sizes, orig, valid = postprocess_case(case)
    vecs, oh_arr, ow_arr, OH, OW = _canvas_vectors(sizes, orig, valid)
    kw = dict(logit_thr=0.0, pack_bytes=OH // 8, pack_cols=OW, kc=8)
    want = [np.asarray(a) for a in jax.jit(
        jpost._device_resize_threshold,
        static_argnames=tuple(kw))(jnp.asarray(logits), *vecs, oh_arr,
                                   ow_arr, **kw)]
    got = [a.numpy() for a in ppost._device_resize_threshold(
        _t(logits), *(_t(v) for v in vecs), _t(oh_arr).long(),
        _t(ow_arr).long())]
    assert [a.dtype for a in got] == [a.dtype for a in want]
    assert [a.shape for a in got] == [a.shape for a in want]
    np.testing.assert_array_equal(got[3], want[3])
    bits_g = np.unpackbits(got[0], axis=-1)          # [B,Q,OW,OH]
    bits_w = np.unpackbits(want[0], axis=-1)
    for b in range(4):
        oh, ow = map(int, orig[b])
        diff = (bits_g[b] != bits_w[b]).transpose(0, 2, 1)[:, :oh, :ow]
        if diff.any():
            near = np.abs(interp64(logits[b], sizes[b], orig[b])) < KNIFE
            assert not (diff & ~near).any(), b
        assert not bits_g[b][:, ow:].any() and not bits_g[b][:, :, oh:].any()
        if not got[3][b] and not diff.any():
            np.testing.assert_array_equal(got[1][b], want[1][b])
            np.testing.assert_array_equal(got[2][b], want[2][b])
    assert got[3].tolist() == ([False] * 4 if case == "blobs"
                               else [False, False, True, True])


def test_interp_vectors_are_a_copy():
    for o, s in ((640, 160), (97, 10), (5, 20)):
        for a, b in zip(ppost._interp_vectors(o, s),
                        jpost._interp_vectors(o, s)):
            np.testing.assert_array_equal(a, b)


def test_init_like_jax_mask_branch():
    """init_like_jax on the mask branch against the JAX package's init:
    every parameter of bbox_attention and mask_head under the same name and
    shape, constants equal, each random one's mean and std within 10% of
    the JAX one's std plus three standard errors."""
    from toist_tpu.train.step import init_variables
    from toist_tpu_torch.models.init import init_like_jax

    jmodel = build_model(SEG, text_vocab_size=VOCAB)
    sample = {"images": np.zeros((1, 64, 64, 3), np.float32),
              "image_mask": np.zeros((1, 64, 64), bool),
              "text_ids": np.full((1, 8), 5, np.int32),
              "text_mask": np.zeros((1, 8), bool)}
    variables = init_variables(jmodel, sample, seed=0)
    want = {k: v for k, v in jax_params_to_state_dict(
        variables["params"], {"frozen": variables["frozen"]}).items()
        if k.startswith(("bbox_attention.", "mask_head."))}
    port = TOIST(_pcfg(SEG), text_vocab_size=VOCAB)
    init_like_jax(port, torch.Generator().manual_seed(0))
    got = {k: v for k, v in port.state_dict().items()
           if k.startswith(("bbox_attention.", "mask_head."))}
    assert set(got) == set(want) and len(got) == 32
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        assert g.shape == w.shape, name
        if w.numel() == 1 or w.std() == 0:
            assert torch.equal(g, w), name
            continue
        sd, n = w.std().item(), w.numel()
        tol = 0.1 * sd + 3 * sd * (2.0 / n) ** 0.5
        assert abs(g.mean().item() - w.mean().item()) <= tol, name
        assert abs(g.std().item() - sd) <= tol, name
