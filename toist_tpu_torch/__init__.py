"""PyTorch/CUDA port of toist_tpu for NVIDIA Hopper (H100).

Each module mirrors its toist_tpu counterpart (models/, ops/, train/,
utils/); the hand-written CUDA kernels live in csrc/ and are built with nvcc
at first use. The package imports torch and never jax, and nothing of
toist_tpu: the host code it shares with the JAX package (config, data,
tokenizer, the native C++ library in native/) is its own copy.
"""
