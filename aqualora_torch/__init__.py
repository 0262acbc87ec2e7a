"""PyTorch + CUDA port of aqualora_tpu for NVIDIA Hopper GPUs."""
