#!/bin/bash
# Verb-noun teacher eval. Twin of scripts/eval_dete_noun.sh for the PyTorch port.
python -m toist_tpu_torch.main --config configs/tdod.json --eval \
  --resume "$1" \
  --set data.verb_noun_input=true model.contrastive_align_loss=false "${@:2}"
