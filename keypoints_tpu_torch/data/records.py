"""Packed on-disk datasets and loaders — port of ``keypoints_tpu/data/records.py``.

One memory-mapped ``.npy`` a store, shape ``(N, C, H, W)`` uint8, with an
optional ``*_pairs.npy`` index of (i, j) temporal pairs and a
``*_meta.json`` provenance sidecar: JAX's format, so a store either package
writes is read byte for byte by the other. Batches move to the device as
uint8 and become float there, so the host does no float math and moves a
quarter of the bytes.

The streams use no ``grain`` (which the card's machine lacks): batch ``i``
is a pure function of ``(seed, i)``. Its row ``r`` is global index
``idx = i * B + r``, in epoch ``idx // n``, at position ``idx % n`` of that
epoch's permutation of the ``n`` items, drawn by numpy from
``SeedSequence([seed, epoch])``. Resuming at batch ``k`` is O(1), as
grain's index-based resume is, and a thread pool can read ahead while
delivering in index order. Grain's order is not matched: the streams are
held to this contract, not to JAX's draws.

The image-folder and video ingest import ``cv2`` inside the function, as
JAX does; they run on the host ahead of training.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional

import numpy as np
import torch


def store_path(path: str) -> str:
    """Normalize a store path to its on-disk ``.npy`` form (``np.save``
    appends ``.npy``, ``np.load`` does not)."""
    return path if path.endswith(".npy") else path + ".npy"


def pairs_path(path: str) -> str:
    """The temporal-pair index filename that belongs to a frame store."""
    return store_path(path)[:-len(".npy")] + "_pairs.npy"


def meta_path(path: str) -> str:
    """The provenance-sidecar filename that belongs to a frame store."""
    return store_path(path)[:-len(".npy")] + "_meta.json"


def write_store_meta(path: str, meta: dict) -> None:
    """Record store provenance (``origin`` + writer details) atomically.

    Synthetic generators record an ``origin`` the eval harness recognizes
    (ground truth may then be regenerated from the same simulator);
    real-footage ingests record their source. A store without a sidecar is
    treated as real footage.
    """
    mp = meta_path(path)
    tmp = mp + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, mp)


def read_store_meta(path: str) -> dict:
    mp = meta_path(path)
    if not os.path.exists(mp):
        return {}
    with open(mp) as f:
        return json.load(f)


class FrameStore:
    """A packed uint8 frame array on disk, with optional temporal-pair index."""

    def __init__(self, path: str):
        self.path = store_path(path)
        self.frames = np.load(self.path, mmap_mode="r")     # (N, C, H, W) u8
        ppath = pairs_path(self.path)
        self.pairs = (np.load(ppath, mmap_mode="r")
                      if os.path.exists(ppath) else None)
        #: provenance sidecar ({} for pre-sidecar / hand-built stores)
        self.meta = read_store_meta(self.path)

    def __len__(self) -> int:
        return len(self.pairs) if self.pairs is not None else len(self.frames)

    @staticmethod
    def write(path: str, frames: np.ndarray,
              pairs: Optional[np.ndarray] = None,
              meta: Optional[dict] = None) -> None:
        if frames.dtype != np.uint8 or frames.ndim != 4:
            raise ValueError(f"a store holds (N, C, H, W) uint8 frames, got "
                             f"{frames.dtype} of shape {frames.shape}")
        path = store_path(path)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.save(path, frames)
        if pairs is not None:
            np.save(pairs_path(path), pairs.astype(np.int32))
        elif os.path.exists(pairs_path(path)):
            os.remove(pairs_path(path))    # don't let an old index linger
        if meta is not None:
            write_store_meta(path, meta)
        elif os.path.exists(meta_path(path)):
            os.remove(meta_path(path))     # stale provenance must not apply


def episode_pairs(episode_lengths: list[int], delta: int = 1) -> np.ndarray:
    """(i, i+delta) index pairs that never cross an episode boundary."""
    out, base = [], 0
    for n in episode_lengths:
        for i in range(n - delta):
            out.append((base + i, base + i + delta))
        base += n
    # keep the (N, 2) contract even when no episode spans delta
    return np.asarray(out, np.int32).reshape(-1, 2)


def _to_device_float(batch_u8: np.ndarray,
                    device: torch.device | str) -> torch.Tensor:
    """Host uint8 → ``device`` uint8 → float32 in [0, 1] on ``device``: the
    copy moves a quarter of the bytes, the divide runs on the device. To a
    CUDA device the copy goes through pinned memory, non-blocking."""
    t = torch.from_numpy(np.ascontiguousarray(batch_u8))
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(device).float() / 255.0


def store_path_for(data) -> str:
    """Canonical on-disk store path for a data config: the one place the
    ``{data_dir}/{dataset}_{size}.npy`` convention lives."""
    return os.path.join(data.data_dir,
                        f"{data.dataset}_{data.image_size}.npy")


def tail_pair_frames(store: FrameStore, pair_mode: str, take: int,
                     device: torch.device | str = "cuda"):
    """→ (a, b, tgt_idx): float32 [0, 1] tensors on ``device`` of the
    store's last ``take`` items, the held-out tail that best-checkpoint
    scoring (``train.heldout_scoring_pair``) and store-backed eval
    (``eval.store_eval_batch``) both read.

    Temporal mode (a pair index exists): items are stored (t, t+Δ) pairs;
    ``tgt_idx`` is each row's target frame index (for landmark lookup).
    Otherwise items are frames, a is b, and the caller applies its own warp
    pairing; ``tgt_idx`` is the frame indices."""
    temporal = pair_mode == "temporal" and store.pairs is not None
    n_items = len(store.pairs) if temporal else len(store.frames)
    take = min(take, n_items)
    if temporal:
        ij = np.asarray(store.pairs[n_items - take:])
        return (_to_device_float(store.frames[ij[:, 0]], device),
                _to_device_float(store.frames[ij[:, 1]], device), ij[:, 1])
    idx = np.arange(n_items - take, n_items)
    f = _to_device_float(store.frames[idx], device)
    return f, f, idx


class IndexBatches:
    """Random access to the item indices of a shuffled, repeated, batched
    range: ``self[i]`` is batch ``i``'s ``(B,)`` int64 indices into
    ``[0, limit)``, restricted to ``range(limit)[shard_index::shard_count]``.
    A pure function of ``(seed, i)``: epoch ``e`` of the shard's items is
    the permutation numpy draws from ``SeedSequence([seed, e])``."""

    def __init__(self, limit: int, batch_size: int, seed: int,
                 shard_index: int = 0, shard_count: int = 1):
        self.items = np.arange(limit)[shard_index::shard_count]
        if not len(self.items):
            raise ValueError(f"shard {shard_index} of {shard_count} over "
                             f"{limit} items is empty")
        self.batch_size = batch_size
        self.seed = seed
        self._last = (-1, self.items)     # (epoch, its order), one tuple

    def epoch(self, e: int) -> np.ndarray:
        last = self._last
        if last[0] != e:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, e]))
            last = self._last = (e, self.items[rng.permutation(len(self.items))])
        return last[1]

    def __getitem__(self, i: int) -> np.ndarray:
        n = len(self.items)
        idx = np.arange(i * self.batch_size, (i + 1) * self.batch_size)
        out = np.empty(self.batch_size, np.int64)
        for e in np.unique(idx // n):
            sel = idx // n == e
            out[sel] = self.epoch(int(e))[idx[sel] % n]
        return out


def _iter_from(read, start_batch: int, workers: int = 1, depth: int = 8):
    """Yield ``read(i)`` for ``i = start_batch, start_batch + 1, ...``.

    With ``workers > 1`` a thread pool materializes ``depth`` upcoming
    batches at once (mmap page reads and numpy gathers release the GIL),
    while delivery order stays the index order."""
    import itertools
    if workers <= 1:
        for i in itertools.count(start_batch):
            yield read(i)
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(workers) as pool:
        buf: deque = deque()
        nxt = start_batch
        for _ in range(depth):
            buf.append(pool.submit(read, nxt))
            nxt += 1
        while True:
            out = buf.popleft().result()
            buf.append(pool.submit(read, nxt))
            nxt += 1
            yield out


def single_stream(store: FrameStore, batch_size: int, seed: int = 0,
                  shard_index: int = 0, shard_count: int = 1,
                  start_batch: int = 0, workers: int = 1,
                  limit: Optional[int] = None,
                  device: torch.device | str = "cuda"
                  ) -> Iterator[torch.Tensor]:
    """Infinite shuffled stream of single-frame batches (warp-mode
    datasets), float32 on ``device``. ``limit`` restricts the stream to
    frames ``[0, limit)``: the trainer reserves the store tail as a
    held-out scoring slice."""
    index = IndexBatches(len(store.frames) if limit is None else limit,
                         batch_size, seed, shard_index, shard_count)

    def read(i):
        return store.frames[index[i]]          # one gather a batch

    for batch in _iter_from(read, start_batch, workers):
        yield _to_device_float(batch, device)


def pair_stream(store: FrameStore, batch_size: int, seed: int = 0,
                shard_index: int = 0, shard_count: int = 1,
                start_batch: int = 0, workers: int = 1,
                limit: Optional[int] = None,
                device: torch.device | str = "cuda"
                ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Infinite shuffled stream of (frame_t, frame_{t+Δ}) batches, float32
    on ``device``. ``limit`` restricts the stream to pair rows
    ``[0, limit)``."""
    if store.pairs is None:
        raise ValueError("store has no temporal-pair index")
    index = IndexBatches(len(store.pairs) if limit is None else limit,
                         batch_size, seed, shard_index, shard_count)

    def read(i):
        ij = store.pairs[index[i]]                              # (B, 2)
        return store.frames[ij[:, 0]], store.frames[ij[:, 1]]

    for a, b in _iter_from(read, start_batch, workers):
        yield _to_device_float(a, device), _to_device_float(b, device)


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Keep ``depth`` batches in flight: the streams' copies to a CUDA
    device are non-blocking, so holding a small queue of issued batches
    overlaps the host read and the copy with the step."""
    from collections import deque
    buf: deque = deque()
    for item in iterator:
        buf.append(item)
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def _list_images(folder: str, limit: Optional[int]) -> list[str]:
    names = sorted(f for f in os.listdir(folder)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    return names[:limit] if limit else names


def _decode_image(path: str, size: int, channels: int) -> np.ndarray:
    """cv2 decode + resize one image → (C, size, size) uint8."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR if channels == 3
                     else cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError(f"cv2 cannot decode image: {path}")
    img = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
    if channels == 3:
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).transpose(2, 0, 1)
    return img[None]


def load_image_folder(folder: str, size: int, channels: int = 3,
                      limit: Optional[int] = None) -> np.ndarray:
    """Decode an image folder (png/jpg) → (N, C, size, size) uint8 frames."""
    names = _list_images(folder, limit)
    frames = np.empty((len(names), channels, size, size), np.uint8)
    for i, name in enumerate(names):
        frames[i] = _decode_image(os.path.join(folder, name), size, channels)
    return frames


def image_folder_to_store(folder: str, out_path: str, size: int,
                          channels: int = 3, limit: Optional[int] = None
                          ) -> str:
    """Decode an image folder to a packed store — offline, one-time.

    Decodes straight into the store memmap, so host RAM stays ~one image.
    The memmap is built at a temp path and moved into place only on
    success: a corrupt image or an interrupt leaves no partial store.
    """
    names = _list_images(folder, limit)
    if not names:
        raise FileNotFoundError(f"no images in {folder}")
    out_path = store_path(out_path)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp_path = out_path + ".tmp"
    try:
        out = np.lib.format.open_memmap(
            tmp_path, mode="w+", dtype=np.uint8,
            shape=(len(names), channels, size, size))
        for i, name in enumerate(names):
            out[i] = _decode_image(os.path.join(folder, name), size, channels)
        out.flush()
        del out
        os.replace(tmp_path, out_path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
    if os.path.exists(pairs_path(out_path)):   # frames-only writer: a stale
        os.remove(pairs_path(out_path))        # index must not apply here
    write_store_meta(out_path, {"origin": "image_folder",
                                "source": os.path.abspath(folder)})
    return out_path


VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".mpg", ".mpeg")


def load_video(path: str, size: int, channels: int = 3, stride: int = 1,
               max_frames: Optional[int] = None) -> np.ndarray:
    """Decode one video file → (N, C, size, size) uint8 frames: every
    ``stride``-th frame, center-cropped to the largest square, resized."""
    import cv2
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cv2 cannot open video: {path}")
    frames, i = [], 0
    while max_frames is None or len(frames) < max_frames:
        ok, img = cap.read()                               # BGR (H, W, 3)
        if not ok:
            break
        if i % stride == 0:
            h, w = img.shape[:2]
            s = min(h, w)
            y0, x0 = (h - s) // 2, (w - s) // 2
            img = img[y0:y0 + s, x0:x0 + s]
            img = cv2.resize(img, (size, size),
                             interpolation=cv2.INTER_AREA)
            if channels == 3:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).transpose(2, 0, 1)
            else:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)[None]
            frames.append(img)
        i += 1
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames).astype(np.uint8)


def video_to_store(source: str, out_path: str, size: int, channels: int = 3,
                   stride: int = 1, delta: int = 1,
                   max_frames_per_video: Optional[int] = None) -> str:
    """Decode video footage to a packed store with a temporal-pair index.

    ``source`` is one video file or a folder of them (sorted by name); each
    file is one episode, so the (i, i+delta) index never crosses a file.
    Each clip spills to a temporary ``.npy`` and the clips stream into the
    final memmap, built at a temp path and moved into place on success.
    """
    if os.path.isdir(source):
        paths = sorted(os.path.join(source, f) for f in os.listdir(source)
                       if f.lower().endswith(VIDEO_EXTS))
        if not paths:
            raise FileNotFoundError(f"no video files in {source}")
    else:
        paths = [source]
    out_path = store_path(out_path)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    store_tmp = out_path + ".tmp"
    tmp_paths, lengths = [], []
    try:
        for i, p in enumerate(paths):
            arr = load_video(p, size, channels, stride, max_frames_per_video)
            tmp = f"{out_path}.clip{i}.tmp.npy"
            np.save(tmp, arr)
            tmp_paths.append(tmp)
            lengths.append(len(arr))
            del arr
        out = np.lib.format.open_memmap(
            store_tmp, mode="w+", dtype=np.uint8,
            shape=(sum(lengths), channels, size, size))
        at = 0
        for tmp, n in zip(tmp_paths, lengths):
            out[at:at + n] = np.load(tmp, mmap_mode="r")
            at += n
        out.flush()
        del out
        os.replace(store_tmp, out_path)
    finally:
        for tmp in tmp_paths + [store_tmp]:
            if os.path.exists(tmp):
                os.remove(tmp)
    pairs = episode_pairs(lengths, delta)
    if len(pairs) == 0:
        print(f"note: no temporal pairs (every clip < {delta + 1} stored "
              f"frames); writing a frames-only store", flush=True)
        if os.path.exists(pairs_path(out_path)):   # don't let an old
            os.remove(pairs_path(out_path))        # index linger
    else:
        np.save(pairs_path(out_path), pairs.astype(np.int32))
    write_store_meta(out_path, {"origin": "video",
                                "source": os.path.abspath(source)})
    return out_path
