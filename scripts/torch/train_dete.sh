#!/bin/bash
# Plain TOIST detection training (reference scripts/train_dete.sh).
# Twin of scripts/train_dete.sh for the PyTorch port: NPROC ranks, one card
# each (default 1); the batch sizes are per rank.
torchrun --standalone --nproc_per_node "${NPROC:-1}" \
  -m toist_tpu_torch.main --config configs/tdod.json \
  --output-dir logs/dete \
  --set optim.train_batch_size=6 optim.valid_batch_size=8 "$@"
