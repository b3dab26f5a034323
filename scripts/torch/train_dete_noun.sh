#!/bin/bash
# Verb-noun teacher training (reference scripts/train_dete_noun.sh): privileged captions.
# Twin of scripts/train_dete_noun.sh for the PyTorch port: NPROC ranks.
torchrun --standalone --nproc_per_node "${NPROC:-1}" \
  -m toist_tpu_torch.main --config configs/tdod.json \
  --output-dir logs/dete_noun \
  --set data.verb_noun_input=true "$@"
