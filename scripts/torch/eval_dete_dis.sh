#!/bin/bash
# Distilled student eval with cluster snapping.
# Twin of scripts/eval_dete_dis.sh for the PyTorch port.
python -m toist_tpu_torch.main --config configs/tdod.json --eval \
  --resume "$1" \
  --set loss.distillation=true loss.softkd_loss=true \
        loss.cluster=true loss.cluster_memory_size=1024 loss.cluster_num=3 \
        model.contrastive_align_loss=false "${@:2}"
