"""Tensor parallelism of the port (``toist_tpu_torch/parallel/tp.py``) on
CPU ranks (gloo) against the JAX package.

- The policy: for every parameter of the port's model at tp 2, 3 and 4,
  its spec against JAX's ``tp_spec`` of the JAX leaves it maps to
  (column-parallel = the torch weight's rows = JAX's kernel columns).
  The port shards a layer only when its heads divide by tp as well; JAX's
  ``tp_spec`` checks the features alone (ROADMAP queue C), which this test
  pins.
- A (1, 2) grid (``tests/torch_ranks.py``, case "tp") and a (2, 2) grid
  start first; JAX's single-device step on the whole batch is computed
  while they run. The model is ``tests/test_torch_parallel.py``'s (1 + 1
  layers, hidden 64, 4 heads, f32). Bounds are JAX's own for its TP step
  (``tests/test_parallel.py:333-339``): loss rtol 2e-5, grad_norm rtol
  2e-4, parameters within 2.5 * lr. At rate 0.1 the replicated tensors
  are bit-equal over the model group; the (2, 2) grid with ZeRO-1 equals
  it without, bit for bit, and the (1, 2) grid within the bounds; the
  consolidated checkpoint holds the whole masters, restores into the grid
  bit for bit, and loads in JAX's ``load_reference_checkpoint``.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests.test_torch_parallel import LR, OPT, PTINY1, _jax_plain, _weights
from tests.test_torch_train import _tiny_batch
from tests.torch_ranks import Ranks
from toist_tpu.parallel.tp import tp_spec
from toist_tpu.utils.convert import (convert_torch_state_dict,
                                     load_reference_checkpoint,
                                     synth_reference_state_dict)
from toist_tpu_torch import config as pconfig
from toist_tpu_torch.models.toist import TOIST
from toist_tpu_torch.parallel import tp
from toist_tpu_torch.train import criterion as pcrit

# -- the policy --------------------------------------------------------------

POLICY_MODEL = dict(backbone="resnet18-test", hidden_dim=48, nheads=6,
                    dim_feedforward=96, enc_layers=1, dec_layers=1,
                    num_queries=8, compute_dtype="float32",
                    contrastive_hdim=16, text_hidden=48, text_layers=1,
                    text_heads=2, text_intermediate=96)
_TEXT = "transformer.text_encoder.encoder.layer."
_HF = {"attention.self.query": "q_proj", "attention.self.key": "k_proj",
       "attention.self.value": "v_proj", "attention.output.dense": "out_proj"}


def _jax_paths(name):
    """The JAX leaves (path tuples) a port parameter maps to, or None for
    the parameters the policy never touches."""
    parts = name.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}
    if name.startswith("transformer.encoder.") or \
            name.startswith("transformer.decoder.layers."):
        side = parts[1]
        layer = f"layer_{parts[3]}"
        mod, rest = parts[4], parts[5:]
        if mod in ("self_attn", "cross_attn_image"):
            if rest[0] in ("in_proj_weight", "in_proj_bias"):
                kind = "kernel" if rest[0].endswith("weight") else "bias"
                return [(side, layer, mod, f"{x}_proj", kind)
                        for x in "qkv"]
            return [(side, layer, mod, "out_proj", leaf[rest[1]])]
        if mod in ("linear1", "linear2"):
            return [(side, layer, "ffn", mod, leaf[rest[0]])]
        return None
    if name.startswith(_TEXT):
        rest = name[len(_TEXT):].split(".")
        layer, sub, kind = f"layer_{rest[0]}", ".".join(rest[1:-1]), rest[-1]
        if sub in _HF:
            return [("text_encoder", layer, "attention", _HF[sub],
                     leaf[kind])]
        if sub in ("intermediate.dense", "output.dense"):
            return [("text_encoder", layer, sub.split(".")[0], leaf[kind])]
    return None


def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("n", [2, 3, 4])
def test_policy_matches_jax_tp_spec(n):
    cfg = pconfig.ModelConfig(**POLICY_MODEL)
    with torch.device("meta"):
        model = TOIST(cfg, text_vocab_size=600)
    specs = tp.model_specs(model, n)
    sd = synth_reference_state_dict(
        stage_sizes=(1, 1, 1, 1), enc=1, dec=1, d=48, dim_feedforward=96,
        text_layers=1, text_hidden=48, text_intermediate=96, num_queries=8,
        vocab_size=600, contrastive_hdim=16, with_masks=False)
    params, _ = convert_torch_state_dict(sd, d_model=48, enc_layers=1,
                                         dec_layers=1,
                                         stage_sizes=(1, 1, 1, 1))
    seen, deviations = set(), []
    heads = {"transformer.text_encoder": cfg.text_heads}
    for name, p in model.named_parameters():
        paths = _jax_paths(name)
        if paths is None:
            assert name not in specs, name
            continue
        jspecs = {tp_spec(path, _tree_get(params, path), n)
                  for path in paths}
        seen.update(paths)
        assert len(jspecs) == 1, (name, jspecs)
        (jspec,) = jspecs
        mine = specs.get(name)
        want = {(0, 3): P(None, "model") if name.endswith("weight")
                else P("model"),
                (0, 1): P(None, "model") if name.endswith("weight")
                else P("model"),
                (1, 1): P("model", None), None: P()}[mine]
        if jspec != want:
            # Only where the features divide and the heads do not.
            h = heads.get(name[:24], cfg.nheads)
            assert mine is None and h % n != 0 and cfg.hidden_dim % n == 0, \
                (name, mine, jspec)
            deviations.append(name)
    # Every JAX leaf the map does not reach is replicated there too.
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        names = tuple(str(getattr(k, "key", k)) for k in path)
        if names not in seen:
            assert tp_spec(names, leaf, n) == P(), names
    assert bool(deviations) == (n in (3, 4)), deviations


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_without_shards_is_torchs(scale):
    """With no tensor sharded, ``tp.clip_grad_norm_`` (the step's one clip)
    gives ``torch.nn.utils.clip_grad_norm_``'s norm and gradients bit for
    bit, below and above max_norm; a split marked sharded in one process
    gives the same norm to rounding."""
    rng = np.random.default_rng(0)
    grads = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * scale)
             for s in ((7, 5), (3,), (100, 20), (1,))]
    params = [torch.nn.Parameter(torch.zeros_like(g)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = g.clone()
    want = torch.nn.utils.clip_grad_norm_(params, 0.1)
    got = [g.clone() for g in grads]
    norm = tp.clip_grad_norm_(got, [False] * 4, 0.1)
    assert torch.equal(norm, want)
    for p, g in zip(params, got):
        assert torch.equal(p.grad, g)
    split = [g.clone() for g in grads]
    norm = tp.clip_grad_norm_(split, [False, True, True, False], 0.1)
    torch.testing.assert_close(norm, want, rtol=1e-6, atol=0)


# -- grids of ranks ----------------------------------------------------------

@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    sd, params, frozen = _weights(5)
    batch = _tiny_batch()
    cfg = pconfig.Config(model=PTINY1, optim=pconfig.OptimConfig(**OPT))
    wd = pcrit.build_weight_dict(cfg.loss, False, 1)
    runs = {}
    for grid in ((1, 2), (2, 2)):
        work = tmp_path_factory.mktemp(f"tp{grid[0]}{grid[1]}")
        runs[grid] = Ranks("tp", work, {
            "cfg": cfg, "wd": wd, "sd": sd, "batch": batch, "grid": grid,
            "workdir": str(work)}, world=grid[0] * grid[1], timeout=600)
    ref = _jax_plain(params, frozen, batch)
    return types.SimpleNamespace(
        ranks={g: r.wait() for g, r in runs.items()}, ref=ref, sd=sd)


def test_tp_step_matches_jax(grids):
    """(1, 2): both ranks' scalars and whole masters equal; against JAX's
    single-device step within its TP bounds. One forward all-reduce per
    row-parallel product: the encoder layer's 2 (attention, FFN), the
    decoder layer's 3 (self, cross, FFN) and the RoBERTa layer's 2: 7."""
    r0, r1 = (r["step"] for r in grids.ranks[1, 2])
    assert r0["scalars"] == r1["scalars"]
    for n in r0["masters"]:
        np.testing.assert_array_equal(r1["masters"][n], r0["masters"][n])
    ref = grids.ref
    np.testing.assert_allclose(r0["scalars"]["loss"], ref["loss"],
                               rtol=2e-5)
    np.testing.assert_allclose(r0["scalars"]["grad_norm"], ref["grad_norm"],
                               rtol=2e-4)
    for n, m in r0["masters"].items():
        np.testing.assert_allclose(m, ref["masters"][n], atol=2.5 * LR,
                                   rtol=0, err_msg=n)
    assert r0["counts"]["fwd"] == 7
    assert "transformer.encoder.layers.0.self_attn.in_proj_weight" in \
        r0["sharded"]


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
def test_replicated_tensors_bit_equal_at_rate_01(grids, grid):
    """At dropout 0.1 the ranks of a model group hold the same replicated
    masters bit for bit after a step (their generators in lockstep), and
    their own halves of the sharded ones."""
    ranks = grids.ranks[grid]
    by_group = {}
    for r in ranks:
        by_group.setdefault(r["grid"][0], []).append(r["dropout"])
    for group in by_group.values():
        a, b = group
        sharded = set(a["sharded"])
        assert sharded and set(a["masters"]) == set(b["masters"])
        for n, v in a["masters"].items():
            if n in sharded:
                assert v.shape == b["masters"][n].shape
            else:
                np.testing.assert_array_equal(v, b["masters"][n], err_msg=n)


def test_zero1_over_the_data_group(grids):
    """(2, 2) with ZeRO-1 over each data group equals (2, 2) without it,
    bit for bit, and (1, 2) within JAX's bounds; each rank of the (2, 2)
    grid keeps about half of its shard's moments."""
    z = [r["zero"] for r in grids.ranks[2, 2]]
    one = grids.ranks[1, 2][0]["zero"][False]["masters"]
    for r in z:
        assert r[True]["zero1"] and not r[False]["zero1"]
        for n, v in r[False]["masters"].items():
            np.testing.assert_array_equal(r[True]["masters"][n], v,
                                          err_msg=n)
            np.testing.assert_allclose(v, one[n], atol=2.5 * LR, rtol=0,
                                       err_msg=n)
        share = r[True]["bytes"] / r[False]["bytes"]
        assert 0.3 < share < 0.7, share
    assert grids.ranks[1, 2][0]["zero"][True]["zero1"] is False


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
def test_consolidated_checkpoint(grids, grid):
    """Rank 0's file holds the whole masters (q, k and v joined chunk by
    chunk), restores into the grid bit for bit, and JAX's
    load_reference_checkpoint reads it."""
    r0 = grids.ranks[grid][0]["ckpt"]
    assert all(r["ckpt"]["restored_equal"] for r in grids.ranks[grid])
    payload = torch.load(r0["path"], weights_only=False)
    assert set(payload["model"]) == set(grids.sd)
    for n, v in r0["masters"].items():
        np.testing.assert_array_equal(payload["model"][n].numpy(), v,
                                      err_msg=n)
        assert payload["model"][n].shape == grids.sd[n].shape
    moments = [s["exp_avg"] for s in payload["optimizer"]["state"].values()]
    assert moments and all(m.dim() for m in moments)
    params, _ = load_reference_checkpoint(
        r0["path"], prefer_ema=False, d_model=64, enc_layers=1,
        dec_layers=1, stage_sizes=(1, 1, 1, 1))
    q = params["encoder"]["layer_0"]["self_attn"]["q_proj"]["kernel"]
    w = payload["model"]["transformer.encoder.layers.0.self_attn."
                         "in_proj_weight"]
    np.testing.assert_array_equal(np.asarray(q), w[:64].numpy().T)
