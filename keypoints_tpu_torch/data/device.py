"""Device-resident datasets — port of ``keypoints_tpu/data/device.py``.

A packed store that fits the card (4,500 Pong frames are 18.4 MB; 2,048
faces at 128² are 100.7 MB) is uploaded once as uint8, and every batch is
drawn on the device: indices from ``torch.randint`` on a device generator,
the frames gathered with ``index_select``, the uint8 → float32 divide on
the device. The host does nothing per step and nothing crosses to the card
after the upload.

The budget is measured: :func:`device_memory_budget` takes the card's free
memory (``torch.cuda.mem_get_info``) less :data:`HEADROOM_BYTES`, and
:data:`DEFAULT_BUDGET_BYTES` where there is no CUDA. Stores over it take
the streams of ``data.records``.

Not ported: ``_HBM_BY_KIND`` and ``device_hbm_bytes``, tables of TPU
memory sizes for backends that report no memory stats (CUDA reports them),
used by the JAX trainer's TPU-only preflight.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from keypoints_tpu_torch.data.records import FrameStore

#: budget where there is no CUDA to ask
DEFAULT_BUDGET_BYTES = 4 << 30
#: kept free for parameters, activations and the allocator's slack
HEADROOM_BYTES = 3 << 30


def device_memory_budget(headroom_bytes: int = HEADROOM_BYTES,
                         device: torch.device | str = "cuda") -> int:
    """Bytes a resident store may take on ``device``: free memory less
    ``headroom_bytes`` on a CUDA device, else :data:`DEFAULT_BUDGET_BYTES`."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return DEFAULT_BUDGET_BYTES
    free, _ = torch.cuda.mem_get_info(device)
    return max(0, free - headroom_bytes)


def fits_in_memory(store: FrameStore, budget_bytes: Optional[int] = None,
                   device: torch.device | str = "cuda") -> bool:
    if budget_bytes is None:
        budget_bytes = device_memory_budget(device=device)
    return store.frames.nbytes <= budget_bytes


class DeviceDataset:
    """A FrameStore uploaded to ``device`` as uint8 (frames, and the pair
    index as int64); raises if it is over the budget."""

    def __init__(self, store: FrameStore, budget_bytes: Optional[int] = None,
                 device: torch.device | str = "cuda"):
        if budget_bytes is None:
            budget_bytes = device_memory_budget(device=device)
        if not fits_in_memory(store, budget_bytes):
            raise ValueError(
                f"store is {store.frames.nbytes / 1e9:.2f} GB, over the "
                f"{budget_bytes / 1e9:.2f} GB device budget — use the "
                f"streams in data.records instead")
        self.frames = torch.from_numpy(np.array(store.frames)).to(device)
        self.pairs = (torch.from_numpy(store.pairs.astype(np.int64))
                      .to(device) if store.pairs is not None else None)

    @property
    def num_frames(self) -> int:
        return self.frames.shape[0]

    def sample(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        return sample_frames(self.frames, generator, batch)

    def sample_pair(self, generator: torch.Generator, batch: int):
        if self.pairs is None:
            raise ValueError("store has no temporal-pair index")
        return sample_pair_frames(self.frames, self.pairs, generator, batch)


def _rows(generator: torch.Generator, batch: int, hi: int,
          device: torch.device) -> torch.Tensor:
    return torch.randint(0, hi, (batch,), generator=generator, device=device)


def sample_frames(frames: torch.Tensor, generator: torch.Generator,
                  batch: int, limit: Optional[int] = None) -> torch.Tensor:
    """``batch`` frames drawn uniformly from ``[0, limit)`` (all frames when
    ``limit`` is None; 0 is not "no limit") on ``generator``, float32 in
    [0, 1] on the frames' device."""
    hi = frames.shape[0] if limit is None else limit
    idx = _rows(generator, batch, hi, frames.device)
    return frames.index_select(0, idx).float() / 255.0


def sample_pair_frames(frames: torch.Tensor, pairs: torch.Tensor,
                       generator: torch.Generator, batch: int,
                       limit: Optional[int] = None):
    """``batch`` (frame_t, frame_{t+Δ}) rows drawn uniformly from pair rows
    ``[0, limit)``, float32 in [0, 1] on the frames' device."""
    hi = pairs.shape[0] if limit is None else limit
    ij = pairs.index_select(0, _rows(generator, batch, hi, frames.device))
    a = frames.index_select(0, ij[:, 0])
    b = frames.index_select(0, ij[:, 1])
    return a.float() / 255.0, b.float() / 255.0
