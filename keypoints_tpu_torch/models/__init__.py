"""Models of the port (the JAX package's ``keypoints_tpu.models``)."""

from keypoints_tpu_torch.models.autoencoder import KeypointAutoencoder
from keypoints_tpu_torch.models.nets import (Conv2d, Decoder, Encoder,
                                             GroupNorm, KeyNet, UpsampleConv)

__all__ = ["KeypointAutoencoder", "Conv2d", "Decoder", "Encoder",
           "GroupNorm", "KeyNet", "UpsampleConv"]
