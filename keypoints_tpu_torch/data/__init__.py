"""Data side of the port (the JAX package's ``keypoints_tpu.data``): the
device-side pair augmentation, ``augment``, and the synthetic temporal
pairs (scripted Pong, moving dots), ``synthetic``."""
