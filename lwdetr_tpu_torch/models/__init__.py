"""Model modules of the PyTorch/CUDA port (eval forward of the ViT presets)."""
