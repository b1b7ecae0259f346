"""Datasets: the reference's build_dataset surface.

Port of ofb_tpu/data/datasets.py. Every dataset yields `(uint8 HWC staging
image, int label)`; all randomised augmentation runs on the device
(`ops/augment.py`). Decode and the static resize to the staging square are
the only host work.

Supported: CIFAR10, CIFAR100, IMNET (ImageFolder), IMNET100 (first 100
classes, with an index cache), INAT / INAT19 (iNaturalist json
annotations), DIGITS (sklearn's bundled digits) and SYNTHETIC. PIL and
sklearn are imported inside the datasets that need them; SYNTHETIC needs
neither.
"""

from __future__ import annotations

import io
import json
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from ..config import DataConfig


class SyntheticDataset:
    """Random images seeded by index, byte-identical to the JAX package's."""

    def __init__(self, size: int, num_classes: int, staging: int):
        self.size = size
        self.num_classes = num_classes
        self.staging = staging

    def __len__(self):
        return self.size

    def __getitem__(self, i):
        rs = np.random.RandomState(i % 65536)
        img = rs.randint(0, 256, (self.staging, self.staging, 3), np.uint8)
        return img, int(i % self.num_classes)


class DigitsDataset:
    """sklearn's handwritten digits (1,797 8x8 images, 10 classes): a
    deterministic 80/20 split, bicubic-upscaled to the staging square."""

    def __init__(self, is_train: bool, staging: int):
        from PIL import Image
        from sklearn.datasets import load_digits
        d = load_digits()
        n = len(d.images)
        idx = np.random.RandomState(0).permutation(n)
        cut = int(n * 0.8)
        idx = idx[:cut] if is_train else idx[cut:]
        self.labels = d.target[idx].astype(np.int64)
        imgs = (d.images[idx] * (255.0 / 16.0)).astype(np.uint8)
        self.images = np.stack([
            np.asarray(Image.fromarray(im).convert("RGB").resize(
                (staging, staging), Image.BICUBIC), np.uint8)
            for im in imgs])

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i])


def resize_u8(pil_img, staging: int) -> np.ndarray:
    """Shorter-side bicubic resize + centre crop to the staging square,
    uint8 HWC."""
    from PIL import Image
    w, h = pil_img.size
    s = staging
    if w < h:
        nw, nh = s, max(s, int(round(h * s / w)))
    else:
        nw, nh = max(s, int(round(w * s / h))), s
    img = pil_img.convert("RGB").resize((nw, nh), Image.BICUBIC)
    x0 = (nw - s) // 2
    y0 = (nh - s) // 2
    return np.asarray(img.crop((x0, y0, x0 + s, y0 + s)), np.uint8)


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp", ".tif",
                  ".tiff")


def scan_image_folder(root: str):
    """ImageFolder listing: one class per subdirectory, sorted class names
    -> indices. Returns (samples [(path, idx)], class_to_idx)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    class_to_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for c in classes:
        for dirpath, _, files in sorted(os.walk(os.path.join(root, c))):
            for f in sorted(files):
                if f.lower().endswith(IMG_EXTENSIONS):
                    samples.append((os.path.join(dirpath, f),
                                    class_to_idx[c]))
    if not samples:
        raise FileNotFoundError(f"no images under {root}")
    return samples, class_to_idx


class FolderDataset:
    """ImageFolder dataset decoded to the staging resolution: JPEGs through
    the native library (`data/native.py`) where it builds, anything else
    (and a missing toolchain) through PIL."""

    def __init__(self, root: str, staging: int,
                 class_subset: Optional[list] = None,
                 native_decode: bool = True):
        samples, self.class_to_idx = scan_image_folder(root)
        self.staging = staging
        self.native_decode = native_decode
        if class_subset is not None:
            keep = set(class_subset)
            remap = {t: i for i, t in enumerate(sorted(keep))}
            samples = [(p, remap[t]) for p, t in samples if t in keep]
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, target = self.samples[i]
        with open(path, "rb") as f:
            data = f.read()
        if self.native_decode and path.lower().endswith((".jpg", ".jpeg")):
            from .native import stage_jpeg
            arr = stage_jpeg(data, self.staging)
            if arr is not None:
                return arr, target
        from PIL import Image
        return resize_u8(Image.open(io.BytesIO(data)), self.staging), target


class CifarDataset:
    """CIFAR-10/100 from the python-version pickle batches under `root`
    (cifar-10-batches-py / cifar-100-python, or the batch dir itself)."""

    def __init__(self, root: str, train: bool, staging: int, cifar100=False):
        self.staging = staging
        if cifar100:
            base = os.path.join(root, "cifar-100-python")
            files = ["train"] if train else ["test"]
            label_key = b"fine_labels"
        else:
            base = os.path.join(root, "cifar-10-batches-py")
            files = [f"data_batch_{i}" for i in range(1, 6)] if train \
                else ["test_batch"]
            label_key = b"labels"
        if not os.path.isdir(base):
            base = root
        datas, labels = [], []
        for fn in files:
            with open(os.path.join(base, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            datas.append(np.asarray(d[b"data"], np.uint8))
            labels.extend(d[label_key])
        self.images = np.concatenate(datas).reshape(-1, 3, 32, 32) \
            .transpose(0, 2, 3, 1)
        self.labels = np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        img = self.images[i]
        s = self.staging
        if s != 32:
            from PIL import Image
            img = np.asarray(
                Image.fromarray(img).resize((s, s), Image.BICUBIC), np.uint8)
        return img, int(self.labels[i])


class INatDataset:
    """iNaturalist 2018 / 2019 json-annotation dataset."""

    def __init__(self, root: str, train: bool, staging: int, year: int = 2018,
                 category: str = "name"):
        split = "train" if train else "val"
        with open(os.path.join(root, f"{split}{year}.json")) as f:
            data = json.load(f)
        with open(os.path.join(root, f"categories{year}.json")) as f:
            cats = json.load(f)
        names = sorted({c[category] for c in cats})
        self.name_to_idx = {n: i for i, n in enumerate(names)}
        self.nb_classes = len(names)
        ann = {a["image_id"]: a["category_id"] for a in data["annotations"]}
        self.samples = [
            (os.path.join(root, img["file_name"]),
             self.name_to_idx[cats[ann[img["id"]]][category]])
            for img in data["images"]]
        self.staging = staging

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image
        path, target = self.samples[i]
        with open(path, "rb") as f:
            return resize_u8(Image.open(f), self.staging), target


def build_dataset(is_train: bool, cfg: DataConfig, staging: int = 256
                  ) -> Tuple[object, int]:
    """(dataset, num_classes) for `cfg.data_set`."""
    name = cfg.data_set.upper()
    if name == "SYNTHETIC":
        return (SyntheticDataset(cfg.synthetic_size, cfg.synthetic_num_classes,
                                 staging), cfg.synthetic_num_classes)
    if name == "DIGITS":
        return DigitsDataset(is_train, staging), 10
    if name == "CIFAR10":
        return CifarDataset(cfg.data_path, is_train, staging), 10
    if name == "CIFAR100":
        return CifarDataset(cfg.data_path, is_train, staging,
                            cifar100=True), 100
    split = "train" if is_train else "val"
    if name == "IMNET":
        return FolderDataset(os.path.join(cfg.data_path, split), staging), 1000
    if name == "IMNET100":
        root = os.path.join(cfg.data_path, split)
        cache = os.path.join(cfg.data_path, f"imnet100_{split}.pkl")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                subset = pickle.load(f)
        else:
            _, class_to_idx = scan_image_folder(root)
            subset = sorted(class_to_idx.values())[:100]
            try:
                with open(cache, "wb") as f:
                    pickle.dump(subset, f)
            except OSError:
                pass
        return FolderDataset(root, staging, class_subset=subset), 100
    if name in ("INAT", "INAT19"):
        ds = INatDataset(cfg.data_path, is_train, staging,
                         year=2018 if name == "INAT" else 2019)
        return ds, ds.nb_classes
    raise ValueError(f"unknown data_set {cfg.data_set}")
