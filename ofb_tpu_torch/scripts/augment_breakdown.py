"""Ablation breakdown of the device-side train augment. Port of
scripts/augment_breakdown.py.

Times the batched train transform of `ops/augment.py` (uint8 staging ->
crop -> flip -> RandAugment -> normalise -> erasing) with its stages
toggled, to see where its time goes before optimising any of it:

  variants: the full pipeline, - erasing, - geometry, - photometric,
  - RandAugment, crop only, the eval-like resize, plus one optimisation
  CANDIDATE (the three shift passes of each RandAugment layer in bf16: they
  move bytes, so halving the bytes should cut their cost; its difference
  from the fp32 pipeline on the same draws is printed, in normalised units,
  where one uint8 step is (1/255)/std ~ 0.017).

Each timed call draws its parameters with `draw_train_augment` and then
applies the variant, as the JAX script draws inside its jitted program.
The full variant equals `apply_train_augment` bit for bit on the same
draws. Runs on the card unless --cpu asks for the CPU; without a card it
raises.

Usage: python -m ofb_tpu_torch.scripts.augment_breakdown [--cpu]
           [--batch 256] [--stage 256] [--out-size 224] [--iters 20]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import augment as A

VARIANTS = (
    ("full (crop+flip+RA+erase)", dict()),
    ("- erasing", dict(erase=False)),
    ("- RA geometry (photo only)", dict(geo=False)),
    ("- RA photometric (geo only)", dict(photo=False)),
    ("- RA entirely", dict(photo=False, geo=False)),
    ("crop only (no flip/RA/erase)",
     dict(flip=False, photo=False, geo=False, erase=False)),
    ("resize only (eval-like)",
     dict(crop=False, flip=False, photo=False, geo=False, erase=False)),
    ("CANDIDATE: bf16 geometry", dict(geo_dtype=torch.bfloat16)),
)


def ra_variant(img, draws, photo=True, geo=True, geo_dtype=None):
    """`ops.augment.rand_augment` with the photometric / geometric slots
    toggled; `geo_dtype` casts the image to it before each layer's three
    shift passes and back after them."""
    for layer in range(draws.ra_op.shape[1]):
        op, sign = draws.ra_op[:, layer], draws.ra_sign[:, layer]
        on = draws.ra_on[:, layer]
        frac = draws.ra_mag[:, layer] / 10.0
        if photo:
            img = A._apply_photo_slot(img, op, frac, 1.0 + sign * frac * 0.9,
                                      on)
        if geo:
            orig = img.dtype
            img = A._geo_slot(img.to(geo_dtype or orig), op, frac, sign,
                              on).to(orig)
    return img


def make_pipeline(out_size: int, crop=True, flip=True, photo=True, geo=True,
                  erase=True, geo_dtype=None):
    """run(images_u8 (B, S, S, 3), draws) -> normalised float (B, out, out,
    3): `apply_train_augment` with stages toggled."""
    def run(images_u8, draws):
        img = images_u8.float()
        if crop:
            img = A.random_resized_crop(img, draws.crop, out_size)
        else:
            img = A.center_crop_resize(img, out_size)
        if flip:
            img = torch.where(A._b(draws.flip), img.flip(2), img)
        if photo or geo:
            img = ra_variant(img, draws, photo=photo, geo=geo,
                             geo_dtype=geo_dtype)
        img = A.normalize(img)
        if erase:
            img = A.random_erasing(img, draws.erase, draws.erase_box,
                                   draws.noise)
        return img
    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--stage", type=int, default=256,
                    help="host staging resolution (uint8 square)")
    ap.add_argument("--out-size", type=int, default=224)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    from ..bench import time_calls
    from ..device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    B, S, O = args.batch, args.stage, args.out_size
    rng = np.random.RandomState(0)
    batch = torch.from_numpy(rng.randint(0, 256, size=(B, S, S, 3),
                                         dtype=np.uint8)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw():
        return A.draw_train_augment(gen, B, S, O, device=dev)

    results = {}
    for name, kw in VARIANTS:
        run = make_pipeline(O, **kw)
        ms = time_calls(lambda: run(batch, draw()).sum(), args.iters,
                        warmup=1) * 1e3
        results[name] = ms
        print(f"{name:38s} {ms:8.1f} ms/batch  "
              f"({B / ms * 1e3:7.1f} img/s)", flush=True)

    # the bf16 candidate against the fp32 pipeline on the same draws: only
    # the resample's precision differs
    gen.manual_seed(0)
    draws = draw()
    ref = make_pipeline(O)(batch, draws)
    cand = make_pipeline(O, geo_dtype=torch.bfloat16)(batch, draws)
    d = (ref - cand).abs().float().cpu().numpy()
    delta = {"mean": float(d.mean()), "p99": float(np.quantile(d, 0.99)),
             "max": float(d.max())}
    print(f"bf16-geometry delta vs f32 (normalized units): "
          f"mean {delta['mean']:.5f}  p99 {delta['p99']:.5f}  "
          f"max {delta['max']:.5f}", flush=True)
    return {"ms": results, "delta": delta}


if __name__ == "__main__":
    main()
