#!/bin/bash
# Distillation segmentation eval (reference scripts/eval_seg_dis.sh):
# cluster snapping active at inference, batch 4, EMA weights.
# Twin of scripts/eval_seg_dis.sh for the PyTorch port.
python -m toist_tpu_torch.main --config configs/tdod.json --eval \
  --resume "$1" \
  --set optim.valid_batch_size=4 model.mask_model=smallconv \
        loss.cluster=true loss.cluster_memory_size=1024 loss.cluster_num=3 \
        model.contrastive_align_loss=false "${@:2}"
