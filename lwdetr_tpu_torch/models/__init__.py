"""Model modules of the PyTorch/CUDA port: the detector, its matcher and its criterion."""
