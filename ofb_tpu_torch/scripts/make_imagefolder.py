"""Generate a synthetic JPEG ImageFolder at production file counts.
Port of scripts/make_imagefolder.py (the same files for the same
arguments and seed).

Where no ImageNet is at hand, this creates the on-disk shape the
reference trains from (datasets.py:90-124: ImageFolder,
class-per-subdirectory, tens of thousands of JPEG files) with *learnable*
class-dependent content (hue + stripe frequency + orientation per class),
variable image sizes, and a train/val split — enough to exercise the full
file-based path: directory scan, native JPEG decode+stage, device augment,
search step.

Usage:
  python -m ofb_tpu_torch.scripts.make_imagefolder --root /tmp/imfolder \
      --classes 40 --per-class 500 --val-per-class 25
"""

from __future__ import annotations

import argparse
import io
import os

import numpy as np


def class_image(rs: np.random.RandomState, cls: int, n_classes: int,
                size: int, noise: float = 0.08) -> np.ndarray:
    """Class-separable RGB pattern: hue from class id, stripes at a
    class-dependent frequency/orientation, plus noise.

    ``noise`` controls difficulty: 0.08 (default) saturates a DeiT-S
    search run's val accuracy within ~20 epochs at 40 classes; 0.35 with
    100 classes keeps top-1 an informative signal at reference cadence
    (used by the registry-geometry ladder so accuracy-vs-FLOPs rungs can
    actually separate).
    """
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    freq = 2.0 + 10.0 * ((cls * 7) % n_classes) / n_classes
    theta = np.pi * ((cls * 13) % n_classes) / n_classes
    wave = np.sin(2 * np.pi * freq *
                  (np.cos(theta) * xx + np.sin(theta) * yy))
    hue = (cls / n_classes) * 2 * np.pi
    base = np.stack([0.5 + 0.35 * np.cos(hue) * wave,
                     0.5 + 0.35 * np.cos(hue + 2.1) * wave,
                     0.5 + 0.35 * np.cos(hue + 4.2) * wave], axis=-1)
    img = base + rs.randn(size, size, 3).astype(np.float32) * noise
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--classes", type=int, default=40)
    ap.add_argument("--per-class", type=int, default=500)
    ap.add_argument("--val-per-class", type=int, default=25)
    ap.add_argument("--min-size", type=int, default=180)
    ap.add_argument("--max-size", type=int, default=320)
    ap.add_argument("--quality", type=int, default=85)
    ap.add_argument("--noise", type=float, default=0.08,
                    help="pattern noise std (0-1 scale); higher = harder")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from PIL import Image

    rs = np.random.RandomState(args.seed)
    total = 0
    for split, per in (("train", args.per_class),
                       ("val", args.val_per_class)):
        for c in range(args.classes):
            cdir = os.path.join(args.root, split, f"class_{c:04d}")
            os.makedirs(cdir, exist_ok=True)
            for i in range(per):
                size = int(rs.randint(args.min_size, args.max_size + 1))
                arr = class_image(rs, c, args.classes, size, args.noise)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "JPEG", quality=args.quality)
                with open(os.path.join(cdir, f"img_{i:05d}.jpg"), "wb") as f:
                    f.write(buf.getvalue())
                total += 1
        print(f"{split}: {args.classes * per} images", flush=True)
    # self-describing probe/train set: ladder_hard_eval records this
    # manifest next to the accuracy numbers it produces
    import json
    with open(os.path.join(args.root, "manifest.json"), "w") as f:
        json.dump({k: getattr(args, k) for k in
                   ("classes", "per_class", "val_per_class", "min_size",
                    "max_size", "quality", "noise", "seed")}, f, indent=2)
    print(f"done: {total} JPEGs under {args.root}", flush=True)


if __name__ == "__main__":
    main()
