"""Input pipeline: host decode -> copy to the device -> augmentation on the
device, a few batches ahead.

Port of ofb_tpu/data/pipeline.py. Host workers only decode and resize to a
fixed staging size (uint8); RandomResizedCrop, flip, RandAugment or color
jitter, normalize and RandomErasing run on the device (`ops/augment.py`).
With num_workers > 0, DataLoader workers decode the next batches and the
DataLoader's own thread copies them into pinned memory while the main
thread dispatches the steps; the main thread then only enqueues each
batch's `non_blocking` copy. With num_workers == 0 the main thread decodes
and pins inside the wait for the next batch. The feed runs `prefetch`
batches ahead of the consumer. Everything stays NHWC: a feed yields images
(A, mb, H, W, 3) and labels (A, mb) on the device.
"""

from __future__ import annotations

import collections
import os
from typing import Iterator, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.augment import eval_preprocess_batch, train_augment_batch
from .samplers import distributed_indices, epoch_batches, ra_indices


class HostLoader:
    """Iterates (uint8 images (B, S, S, 3), int32 labels (B,)) numpy batches
    of one epoch's index plan, with torch DataLoader workers for decode
    when num_workers > 0. `batches` yields the same as torch tensors."""

    def __init__(self, dataset, batch_indices: np.ndarray,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_indices = batch_indices
        self.num_workers = num_workers

    def __len__(self):
        return len(self.batch_indices)

    def __iter__(self):
        for x, y in self.batches():
            yield x.numpy(), y.numpy().astype(np.int32)

    def batches(self, pin_memory: bool = False):
        """(uint8 images, int64 labels) CPU tensors. With pin_memory and
        workers, the DataLoader's thread pins them (for a CUDA feed)."""
        if self.num_workers > 0:
            yield from self._iter_workers(pin_memory)
            return
        for batch in self.batch_indices:
            out = self._native_batch(batch)
            if out is None:
                imgs, lbls = zip(*(self.dataset[int(i)] for i in batch))
                out = np.stack(imgs), lbls
            yield (torch.from_numpy(np.ascontiguousarray(out[0])),
                   torch.from_numpy(np.asarray(out[1], np.int64)))

    def _native_batch(self, batch):
        """The whole batch staged by one call into the native library's
        thread pool, when the dataset is a folder of JPEG files."""
        ds = self.dataset
        if not (hasattr(ds, "samples") and hasattr(ds, "staging")):
            return None
        from .native import native_available, stage_jpeg_batch
        pairs = [ds.samples[int(i)] for i in batch]
        if not all(p.lower().endswith((".jpg", ".jpeg")) for p, _ in pairs) \
                or not native_available():
            return None
        datas = []
        for p, _ in pairs:
            with open(p, "rb") as f:
                datas.append(f.read())
        imgs = stage_jpeg_batch(datas, ds.staging,
                                nthreads=os.cpu_count() or 4)
        return imgs, [t for _, t in pairs]

    def _iter_workers(self, pin_memory):
        from torch.utils.data import DataLoader, Dataset

        ds = self.dataset
        flat = self.batch_indices.reshape(-1)

        class _View(Dataset):
            def __len__(self):
                return len(flat)

            def __getitem__(self, i):
                img, lbl = ds[int(flat[i])]
                return torch.from_numpy(np.ascontiguousarray(img)), lbl

        yield from DataLoader(_View(), batch_size=self.batch_indices.shape[1],
                              shuffle=False, num_workers=self.num_workers,
                              drop_last=False, pin_memory=pin_memory)


def epoch_plan(n: int, *, epoch: int, rank: int, world: int,
               batch_size: int, repeated_aug: bool, train: bool,
               seed: int) -> np.ndarray:
    """(num_batches, batch_size) indices of one epoch: repeated-augmentation
    sampling for training (when on), the distributed sampler otherwise;
    training drops the last partial batch, evaluation pads it. A rank whose
    eval shard is smaller than one batch takes it as one smaller batch
    (`epoch_batches` cannot pad a batch out of fewer indices)."""
    if train and repeated_aug:
        idx = ra_indices(n, epoch, rank, world, seed=seed)
    else:
        idx = distributed_indices(n, epoch, rank, world, shuffle=train,
                                  seed=seed)
    if not train:
        batch_size = min(batch_size, max(len(idx), 1))
    return epoch_batches(idx, batch_size, drop_last=train)


def make_epoch_loader(dataset, *, epoch: int, rank: int, world: int,
                      batch_size: int, repeated_aug: bool = True,
                      train: bool = True, seed: int = 0,
                      num_workers: int = 0) -> HostLoader:
    plan = epoch_plan(len(dataset), epoch=epoch, rank=rank, world=world,
                      batch_size=batch_size, repeated_aug=repeated_aug,
                      train=train, seed=seed)
    return HostLoader(dataset, plan, num_workers=num_workers)


def _split_accum(x: torch.Tensor, y: torch.Tensor, accum_iter: int):
    """A macro batch (B, ...) as accum_iter microbatches (A, mb, ...)."""
    mb = x.shape[0] // accum_iter
    n = mb * accum_iter
    return (x[:n].reshape(accum_iter, mb, *x.shape[1:]),
            y[:n].reshape(accum_iter, mb))


def _prefetched(it, prefetch: int):
    """Run `it` `prefetch` items ahead of the consumer."""
    buf = collections.deque()
    for item in it:
        buf.append(item)
        if len(buf) > prefetch:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def _transform(x, generator, *, raw, train, out_size, use_randaug, re_prob,
               crop_scale, hflip):
    if raw:
        return x
    if train:
        return train_augment_batch(generator, x, out_size=out_size,
                                   use_randaug=use_randaug, re_prob=re_prob,
                                   crop_scale=crop_scale, hflip=hflip)
    return eval_preprocess_batch(x, out_size)


def to_device(x: torch.Tensor, y: torch.Tensor, dev: torch.device):
    """CPU batch -> device tensors (uint8 images, int64 labels), copied
    asynchronously from pinned memory when the device is a GPU (pinned
    here, on the calling thread, unless the loader's thread already did)."""
    if dev.type == "cuda" and not x.is_pinned():
        x, y = x.pin_memory(), y.pin_memory()
    return x.to(dev, non_blocking=True), y.to(dev, non_blocking=True)


def device_feed(loader: HostLoader, *, generator=None, train: bool,
                accum_iter: int = 1, out_size: int = 224,
                use_randaug: bool = True, re_prob: float = 0.25,
                crop_scale=(0.08, 1.0), hflip: bool = True,
                prefetch: int = 2, raw: bool = False, device="cuda"
                ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yields (images (A, mb, H, W, 3) float32, labels (A, mb)) on `device`
    with the transform applied (train: drawn from `generator`, a generator
    on `device`), `prefetch` batches ahead. raw=True yields the uint8
    staging batches untransformed, for steps built with fused_augment."""
    dev = resolve_device(device)
    if train and not raw and generator is None:
        raise ValueError("a train feed needs a `generator` to draw from")

    def produce():
        for imgs, lbls in loader.batches(pin_memory=dev.type == "cuda"):
            x, y = to_device(imgs, lbls, dev)
            x = _transform(x, generator, raw=raw, train=train,
                           out_size=out_size, use_randaug=use_randaug,
                           re_prob=re_prob, crop_scale=crop_scale,
                           hflip=hflip)
            yield _split_accum(x, y, accum_iter)

    yield from _prefetched(produce(), prefetch)


def build_device_cache(dataset, *, chunk: int = 1024,
                       max_bytes: int = 12 << 30, device="cuda"):
    """Decode the whole dataset once at the staging resolution and keep it
    on the device as one uint8 array: every later epoch gathers its
    batches there instead of decoding and copying them again.

    Returns (cache uint8 (N, S, S, 3) on `device`, labels int32 (N,)
    numpy). Raises ValueError above `max_bytes`."""
    dev = resolve_device(device)
    n = len(dataset)
    s = int(dataset.staging)
    nbytes = n * s * s * 3
    if nbytes > max_bytes:
        raise ValueError(
            f"device cache would need {nbytes / 2**30:.1f} GiB "
            f"(> {max_bytes / 2**30:.1f} GiB cap); use the host loader")
    cache = torch.empty((n, s, s, 3), dtype=torch.uint8, device=dev)
    labels = np.empty((n,), np.int32)
    chunks = [np.arange(i, min(i + chunk, n)) for i in range(0, n, chunk)]
    i0 = 0
    for imgs, lbls in HostLoader(dataset, chunks).batches():
        cache[i0:i0 + len(imgs)].copy_(to_device(imgs, lbls, dev)[0])
        labels[i0:i0 + len(imgs)] = lbls.numpy()
        i0 += len(imgs)
    if i0 != n:
        raise RuntimeError(f"device cache staged {i0} of {n} images")
    return cache, labels


def device_cache_feed(cache: torch.Tensor, labels: np.ndarray, *,
                      generator=None, epoch: int, rank: int, world: int,
                      batch_size: int, repeated_aug: bool = True,
                      train: bool = True, seed: int = 0, accum_iter: int = 1,
                      out_size: int = 224, use_randaug: bool = True,
                      re_prob: float = 0.25, crop_scale=(0.08, 1.0),
                      hflip: bool = True, prefetch: int = 2, raw: bool = False
                      ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """`device_feed` over a `build_device_cache` array: the same epoch index
    plan (same samplers, same seeds) and the same transform, but each batch
    is gathered on the device. Single-process only."""
    dev = cache.device
    if train and not raw and generator is None:
        raise ValueError("a train feed needs a `generator` to draw from")
    plan = epoch_plan(int(cache.shape[0]), epoch=epoch, rank=rank,
                      world=world, batch_size=batch_size,
                      repeated_aug=repeated_aug, train=train, seed=seed)
    plan_dev = torch.from_numpy(plan.astype(np.int64)).to(dev)
    labels_dev = torch.from_numpy(labels.astype(np.int64)).to(dev)

    def produce():
        for b in plan_dev:
            x = _transform(cache.index_select(0, b), generator, raw=raw,
                           train=train, out_size=out_size,
                           use_randaug=use_randaug, re_prob=re_prob,
                           crop_scale=crop_scale, hflip=hflip)
            yield _split_accum(x, labels_dev[b], accum_iter)

    yield from _prefetched(produce(), prefetch)
