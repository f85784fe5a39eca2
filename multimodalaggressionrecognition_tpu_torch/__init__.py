"""PyTorch/CUDA port of multimodalaggressionrecognition_tpu for NVIDIA Hopper.

The JAX package beside it stays the reference.  The port mirrors its module
paths (models/, ops/, io/, serve.py, cli/), keeps its public layouts
(channels-last sequences, {modality: {"data", "present"}} batches), and
replaces each Pallas kernel on a ported path with a CUDA kernel written for
sm_90a (csrc/), built with nvcc on first use.  It imports torch and numpy,
never jax or the JAX package.
"""
