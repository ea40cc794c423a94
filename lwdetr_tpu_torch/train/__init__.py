"""Training of the PyTorch/CUDA port: optimizer, EMA and the train step."""
