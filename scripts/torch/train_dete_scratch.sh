#!/bin/bash
# From-scratch training (reference --without_pretrain, README.md:112-125):
# no pretrained weights anywhere; GroupNorm backbone so norms can train.
# Twin of scripts/train_dete_scratch.sh for the PyTorch port: NPROC ranks.
torchrun --standalone --nproc_per_node "${NPROC:-1}" \
  -m toist_tpu_torch.main --config configs/tdod.json \
  --output-dir logs/dete_scratch \
  --set model.without_pretrain=true model.backbone_norm=group_norm "$@"
