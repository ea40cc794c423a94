"""PyTorch/CUDA port of LW-DETR: eval, training and the demo of the ViT presets on an NVIDIA H100.

The JAX package `lwdetr_tpu` is the reference it is held against; this
package imports none of it.
"""
