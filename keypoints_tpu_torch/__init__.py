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
  Adam with the warmup-cosine schedule;
* the perceptual loss of pose256: ``train.make_loss`` →
  ``losses.make_perceptual_loss`` over ``models.vgg`` (the VGG-16 trunk to
  relu3_3, its 2×2 max pools), for ``make_train_step(cfg, loss=...)``;
* the Transporter (transporter_atari): ``models.Transporter`` from
  ``training.build_model``, trained through the temporal mode of
  ``make_train_step`` on (source, target) frame pairs, such as the
  scripted-Pong pairs of ``data.synthetic``;
* evaluation (``eval``, ``python -m keypoints_tpu_torch.eval``) on the
  synthetic sets and on a store's held-out tail;
* the train loop (``train``, ``python -m keypoints_tpu_torch.train``): batch
  sources from the synthetic generators and the packed frame stores
  (``data.records``, ``data.device``; written by ``data.faces``,
  ``data.pose`` and ``data.collect``), native checkpoints with bit-exact
  resume (``checkpoint.CheckpointManager``), logging (``viz.Logger``);
* data parallelism (``parallel``): the train step, the loop and resume on
  ``torch.distributed`` under ``torchrun`` (``parallel.multihost``), and
  serving over several cards (``parallel.dp.make_dp_extract``).

The soft-argmax (forward and backward), the Gaussian raster (forward and
backward), the fused soft-argmax → raster bottleneck, the bilinear warps
(dense grid and coarse field) and the 2×2 max pool (forward and backward)
run hand-written CUDA kernels on CUDA tensors (``kernels``, sources in
``csrc/``) and their plain PyTorch versions on CPU tensors (``ops``).
"""
