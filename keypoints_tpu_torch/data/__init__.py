"""Data side of the port (the JAX package's ``keypoints_tpu.data``): so far
the device-side pair augmentation, ``augment``."""
