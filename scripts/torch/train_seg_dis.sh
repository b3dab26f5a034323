#!/bin/bash
# Distillation segmentation (reference scripts/train_seg_dis.sh): frozen distilled detector.
# Twin of scripts/train_seg_dis.sh for the PyTorch port: NPROC ranks.
torchrun --standalone --nproc_per_node "${NPROC:-1}" \
  -m toist_tpu_torch.main --config configs/tdod.json \
  --load "$1" \
  --set optim.train_batch_size=2 optim.valid_batch_size=4 \
        model.mask_model=smallconv model.frozen_detector=true \
        loss.aux_loss=false loss.cluster=true model.contrastive_align_loss=false \
  --output-dir logs/seg_dis "${@:2}"
