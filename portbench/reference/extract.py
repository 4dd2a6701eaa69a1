"""Reference keypoints of uint8 frames: rescaled to [0, 1], Psi and the
marginal soft-argmax in float32 with TF32 off, in blocks of frames."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref


def keypoints(spec: dict, params: dict, frames: np.ndarray, device,
              lowp=None, block: int = 256) -> np.ndarray:
    """(M, C, H, W) uint8 -> (M, K, 2) float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        with torch.no_grad():
            for lo in range(0, len(frames), block):
                x = torch.from_numpy(frames[lo:lo + block]).to(device)
                out.append(ref.extract(params, spec["model"],
                                       x.float() / 255.0, lowp).cpu())
        return torch.cat(out).numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
