"""PyTorch/CUDA port of ``keypoints_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference the port is held against;
module names follow it so each counterpart is easy to find. This package
imports ``torch`` and ``numpy`` and never ``jax`` or ``keypoints_tpu``.

Ported so far:

* the keypoint-serving path: ``configs`` → ``training.build_model`` →
  ``models`` (KeyNet Ψ + soft-argmax) → ``export.BucketedExtract`` →
  ``serve`` (``python -m keypoints_tpu_torch.serve``);
* the training step: ``training.init_state`` and ``make_train_step`` —
  ``data.augment`` (TPS/affine warps, ``ops.color`` jitter) → ``models``
  (Φ, Ψ, soft-argmax, Gaussian raster, decoder) → ``losses.l2_loss`` →
  Adam with the warmup-cosine schedule.

The soft-argmax (forward and backward), the Gaussian raster (forward and
backward) and the bilinear warp run hand-written CUDA kernels on CUDA tensors
(``kernels``, sources in ``csrc/``) and their plain PyTorch versions on CPU
tensors (``ops``).
"""
