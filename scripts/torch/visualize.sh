#!/bin/bash
# GT vs prediction PNGs. Twin of scripts/visualize.sh for the PyTorch port.
python -m toist_tpu_torch.visualize --config configs/tdod.json \
  --resume "$1" --output-dir visualizations "${@:2}"
