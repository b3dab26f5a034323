#!/bin/bash
# Detection eval (reference scripts/eval_dete.sh): EMA weights, no contrastive align.
# Twin of scripts/eval_dete.sh for the PyTorch port; add --device cpu for no card.
python -m toist_tpu_torch.main --config configs/tdod.json --eval \
  --resume "$1" \
  --set optim.valid_batch_size=8 model.contrastive_align_loss=false "${@:2}"
