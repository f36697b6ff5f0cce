"""Preprocessors (counterpart of ray_tpu/data/preprocessors.py;
reference: python/ray/data/preprocessor.py +
preprocessors/{scaler,encoder,chain,batch_mapper}.py): fit on a Dataset,
transform Datasets or single batches."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .block import Block
from .dataset import Dataset


class Preprocessor:
    _fitted = False

    def fit(self, ds: Dataset) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds: Dataset) -> Dataset:
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit() first")
        return ds.map_batches(self.transform_batch)

    def fit_transform(self, ds: Dataset) -> Dataset:
        return self.fit(ds).transform(ds)

    def _fit(self, ds: Dataset) -> None:
        pass

    def _needs_fit(self) -> bool:
        return True

    def transform_batch(self, batch: Block) -> Block:
        raise NotImplementedError


class StandardScaler(Preprocessor):
    def __init__(self, columns: Sequence[str]):
        self.columns = list(columns)
        self.stats: Dict[str, tuple] = {}

    def _fit(self, ds: Dataset) -> None:
        sums = {c: (0.0, 0.0, 0) for c in self.columns}
        for block in ds.iter_blocks():
            for c in self.columns:
                v = block[c].astype(np.float64)
                s, s2, n = sums[c]
                sums[c] = (s + v.sum(), s2 + (v ** 2).sum(), n + len(v))
        for c, (s, s2, n) in sums.items():
            mean = s / max(n, 1)
            var = max(s2 / max(n, 1) - mean ** 2, 1e-12)
            self.stats[c] = (mean, float(np.sqrt(var)))

    def transform_batch(self, batch: Block) -> Block:
        out = dict(batch)
        for c, (mean, std) in self.stats.items():
            out[c] = ((batch[c] - mean) / std).astype(np.float32)
        return out


class MinMaxScaler(Preprocessor):
    def __init__(self, columns: Sequence[str]):
        self.columns = list(columns)
        self.ranges: Dict[str, tuple] = {}

    def _fit(self, ds: Dataset) -> None:
        r = {c: (np.inf, -np.inf) for c in self.columns}
        for block in ds.iter_blocks():
            for c in self.columns:
                lo, hi = r[c]
                r[c] = (min(lo, block[c].min()), max(hi, block[c].max()))
        self.ranges = {c: (lo, max(hi - lo, 1e-12)) for c, (lo, hi)
                       in r.items()}

    def transform_batch(self, batch: Block) -> Block:
        out = dict(batch)
        for c, (lo, span) in self.ranges.items():
            out[c] = ((batch[c] - lo) / span).astype(np.float32)
        return out


class LabelEncoder(Preprocessor):
    def __init__(self, column: str):
        self.column = column
        self.classes_: List = []

    def _fit(self, ds: Dataset) -> None:
        seen = set()
        for block in ds.iter_blocks():
            seen.update(np.unique(block[self.column]).tolist())
        self.classes_ = sorted(seen)

    def transform_batch(self, batch: Block) -> Block:
        table = {v: i for i, v in enumerate(self.classes_)}
        out = dict(batch)
        out[self.column] = np.asarray(
            [table[v] for v in batch[self.column]], dtype=np.int32)
        return out


class BatchMapper(Preprocessor):
    def __init__(self, fn: Callable[[Block], Block]):
        self.fn = fn

    def _needs_fit(self) -> bool:
        return False

    def transform_batch(self, batch: Block) -> Block:
        return self.fn(batch)


class Chain(Preprocessor):
    def __init__(self, *steps: Preprocessor):
        self.steps = list(steps)

    def fit(self, ds: Dataset) -> "Chain":
        cur = ds
        for s in self.steps:
            s.fit(cur)
            cur = s.transform(cur)
        self._fitted = True
        return self

    def transform_batch(self, batch: Block) -> Block:
        for s in self.steps:
            batch = s.transform_batch(batch)
        return batch


class Tokenizer(Preprocessor):
    """Text -> fixed-length token ids using a callable tokenizer (e.g. HF).

    tokenize_fn(list[str]) -> np.ndarray (N, max_len) int32.
    """

    def __init__(self, column: str, tokenize_fn, output_column="tokens"):
        self.column = column
        self.tokenize_fn = tokenize_fn
        self.output_column = output_column

    def _needs_fit(self) -> bool:
        return False

    def transform_batch(self, batch: Block) -> Block:
        out = dict(batch)
        texts = [str(t) for t in batch[self.column]]
        out[self.output_column] = np.asarray(self.tokenize_fn(texts),
                                             dtype=np.int32)
        return out


class ImageAugmenter(Preprocessor):
    """Host-side decode-time augmentation for the image pipeline
    (reference: the torchvision transform stacks ray.data examples feed
    TorchTrainer; here numpy-only so dense uint8 blocks stay the wire
    format and the device sees ready float batches).

    Operates on an "image" column of (N, H, W, C) uint8: optional
    horizontal random flip + random crop (pad-and-crop), then scales to
    float32 and normalizes with per-channel mean/std (defaults: simple
    [0,1] scaling)."""

    def __init__(self, *, flip: bool = True, crop_padding: int = 0,
                 mean=None, std=None, column: str = "image",
                 seed: int = 0):
        self.flip = flip
        self.crop_padding = crop_padding
        self.mean = None if mean is None else np.asarray(
            mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)
        self.column = column
        self._rng = np.random.RandomState(seed)

    def _needs_fit(self) -> bool:
        return False

    def transform_batch(self, batch: Block) -> Block:
        imgs = batch[self.column]
        if imgs.dtype == object:
            raise ValueError(
                "ImageAugmenter needs a dense (N,H,W,C) image column; "
                "pass size=(H,W) to read_images")
        n, h, w, _c = imgs.shape
        if self.flip:
            do = self._rng.rand(n) < 0.5
            imgs = np.where(do[:, None, None, None],
                            imgs[:, :, ::-1, :], imgs)
        if self.crop_padding > 0:
            p = self.crop_padding
            padded = np.pad(imgs, ((0, 0), (p, p), (p, p), (0, 0)),
                            mode="reflect")
            ys = self._rng.randint(0, 2 * p + 1, size=n)
            xs = self._rng.randint(0, 2 * p + 1, size=n)
            imgs = np.stack([padded[i, ys[i]:ys[i] + h,
                                    xs[i]:xs[i] + w] for i in range(n)])
        out = dict(batch)
        x = imgs.astype(np.float32) / 255.0
        if self.mean is not None or self.std is not None:
            mean = self.mean if self.mean is not None else 0.0
            std = self.std if self.std is not None else 1.0
            x = (x - mean) / std
        out[self.column] = x
        return out
