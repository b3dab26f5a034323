#!/bin/bash
# Segmentation eval. Twin of scripts/eval_seg.sh for the PyTorch port.
python -m toist_tpu_torch.main --config configs/tdod.json --eval \
  --resume "$1" \
  --set optim.valid_batch_size=4 model.mask_model=smallconv \
        model.contrastive_align_loss=false "${@:2}"
