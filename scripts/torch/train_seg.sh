#!/bin/bash
# Segmentation training (reference scripts/train_seg.sh): frozen detector, mask head only.
# Twin of scripts/train_seg.sh for the PyTorch port: NPROC ranks.
torchrun --standalone --nproc_per_node "${NPROC:-1}" \
  -m toist_tpu_torch.main --config configs/tdod.json \
  --load "$1" \
  --output-dir logs/seg \
  --set optim.train_batch_size=2 optim.valid_batch_size=4 \
        model.mask_model=smallconv model.frozen_detector=true \
        loss.aux_loss=false model.contrastive_align_loss=false "${@:2}"
