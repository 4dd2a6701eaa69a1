"""PyTorch/CUDA port of ``keypoints_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference the port is held against;
module names follow it so each counterpart is easy to find. This package
imports ``torch`` and ``numpy`` and never ``jax`` or ``keypoints_tpu``.

What is ported so far is the keypoint-serving path: ``configs`` → ``training
.build_model`` → ``models`` (KeyNet Ψ + soft-argmax) → ``export
.BucketedExtract`` → ``serve`` (``python -m keypoints_tpu_torch.serve``).
The soft-argmax runs a hand-written CUDA kernel on CUDA tensors
(``kernels.spatial_softmax_cuda``) and its plain PyTorch version on CPU
tensors (``ops.spatial_softmax``).
"""
