"""Data side of the port (the JAX package's ``keypoints_tpu.data``): the
device-side pair augmentation, ``augment``; the synthetic temporal pairs
(scripted Pong, moving dots), ``synthetic``; the synthetic faces and
figures with their store writers, ``faces`` and ``pose``; the packed frame
stores and their streams, ``records``; device-resident sampling,
``device``; and rollout collection, ``collect``."""
