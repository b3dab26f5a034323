#!/bin/bash
# Noun-pronoun distillation training (reference scripts/train_dete_dis.sh).
# $1 = pronoun (student) warm start, $2 = noun (teacher) warm start: a
# reference or port .pth, or a JAX checkpoint converted to .npz by
# scripts/jax_checkpoint_to_npz.py.
# Twin of scripts/train_dete_dis.sh for the PyTorch port: NPROC ranks.
torchrun --standalone --nproc_per_node "${NPROC:-1}" \
  -m toist_tpu_torch.main --config configs/tdod.json \
  --load "$1" \
  --set run.load_noun="$2" \
        optim.train_batch_size=3 optim.valid_batch_size=8 \
        loss.distillation=true loss.softkd_loss=true loss.softkd_coef=50 \
        loss.cluster=true loss.cluster_memory_size=1024 loss.cluster_num=3 \
        loss.cluster_feature_loss=1e4 \
  --output-dir logs/dete_dis "${@:3}"
