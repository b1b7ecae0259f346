"""File-list dataset and forever iterator.

Port of ofb_tpu/data/file_list.py: `parse_image_list` reads "path label"
lines, `ImageList` decodes such a list to the uint8 staging square (as
every dataset of `data/datasets.py` does), and `ForeverDataIterator`
re-iterates a loader without end, asking its factory for the next epoch's
loader each pass. No CLI uses them; they serve code built on the
reference's auxiliary dataset package.
"""

from __future__ import annotations

import os
from typing import List, Tuple


def parse_image_list(list_path: str, root: str = ""
                     ) -> List[Tuple[str, int]]:
    """[(root/path, label)] of a file of 'path label' lines; a line
    without a label gets 0, blank lines are skipped."""
    samples = []
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.rsplit(" ", 1)
            label = int(parts[1]) if len(parts) == 2 else 0
            samples.append((os.path.join(root, parts[0]), label))
    return samples


class ImageList:
    """Dataset over an explicit (path, label) list, or a list file, each
    image decoded to a (staging, staging, 3) uint8 square."""

    def __init__(self, list_path_or_samples, staging: int = 256,
                 root: str = ""):
        if isinstance(list_path_or_samples, str):
            self.samples = parse_image_list(list_path_or_samples, root)
        else:
            self.samples = list(list_path_or_samples)
        self.staging = staging
        self.classes = sorted({t for _, t in self.samples})

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image
        from .datasets import resize_u8
        path, target = self.samples[i]
        with open(path, "rb") as f:
            arr = resize_u8(Image.open(f), self.staging)
        return arr, target


class ForeverDataIterator:
    """Re-iterates a loader without end. `loader_factory(epoch)` gives the
    loader of an epoch (so it can reshuffle), or a plain iterable is
    re-iterated as it is; `epoch` counts the passes begun."""

    def __init__(self, loader_factory, start_epoch: int = 0):
        if callable(loader_factory):
            self.factory = loader_factory
        else:
            self.factory = lambda _epoch: loader_factory
        self.epoch = start_epoch
        self._it = iter(self.factory(self.epoch))

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self.epoch += 1
            self._it = iter(self.factory(self.epoch))
            return next(self._it)

    def __iter__(self):
        return self
