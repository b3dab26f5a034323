#!/usr/bin/env python
"""Convert a checkpoint of the JAX package (the orbax TrainState that
``toist_tpu.train.checkpoint.save`` writes) into one ``.npz`` that the
PyTorch port's ``--load``, ``run.load_noun`` and
``Predictor.from_checkpoint`` read with numpy alone.

The file holds, under '/'-joined keys of their trees:
  params/...        the trained params (``load_params(prefer_ema=False)``)
  ema_params/...    the EMA params, when the run kept them
  frozen/...        the frozen collections (FrozenBN statistics)
  cluster_bank/...  the cluster bank's four arrays, when the run had one
  epoch             the epoch the checkpoint was written after

The port maps the params through ``utils/convert.jax_params_to_state_dict``
and the bank through ``cluster_bank_from_jax``. The optimizer state is not
converted: ``--resume`` of a JAX run is not supported.

Run where the JAX package trained (it imports ``toist_tpu`` and orbax):
  python scripts/jax_checkpoint_to_npz.py <checkpoint dir> <out.npz>
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def flatten(tree, prefix: str) -> dict:
    """{'/'-joined key: numpy array} of a nested dict's leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def convert(ckpt_dir: str, out_path: str) -> dict:
    import orbax.checkpoint as ocp

    from toist_tpu.train.checkpoint import load_params

    params, frozen = load_params(ckpt_dir, prefer_ema=False)
    payload = ocp.PyTreeCheckpointer().restore(os.path.abspath(ckpt_dir))
    state = payload["state"]
    flat = {**flatten(params, "params"), **flatten(frozen, "frozen"),
            "epoch": np.asarray(payload["epoch"])}
    for key in ("ema_params", "cluster_bank"):
        if state.get(key) is not None:
            flat.update(flatten(state[key], key))
    np.savez(out_path, **flat)
    return flat


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", help="orbax checkpoint directory")
    p.add_argument("out", help="the .npz to write")
    args = p.parse_args(argv)
    flat = convert(args.checkpoint, args.out)
    print(f"wrote {len(flat)} arrays to {args.out}")


if __name__ == "__main__":
    main()
