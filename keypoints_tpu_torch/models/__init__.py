"""Models of the port (the JAX package's ``keypoints_tpu.models``)."""

from keypoints_tpu_torch.models.autoencoder import KeypointAutoencoder
from keypoints_tpu_torch.models.nets import Encoder, GroupNorm, KeyNet

__all__ = ["KeypointAutoencoder", "Encoder", "GroupNorm", "KeyNet"]
