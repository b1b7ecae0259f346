"""Benchmark the file-based data path: native JPEG decode+stage vs PIL.
Port of scripts/data_bench.py (host only: no device is touched).

The native library (native/ofb_dataprep.cpp, bound by `data/native.py`)
exists to keep the step fed from on-disk ImageFolders (the reference
trains from one, datasets.py:90-124); this measures whether it does.
Reports img/s for: PIL decode + resize (`data/datasets.py:resize_u8`),
native single-image, native threaded batch (1..N threads), and the
end-to-end `FolderDataset.__getitem__` path. Where the native library
does not build (no libjpeg headers) it prints the PIL row and stops.

Usage:
  python -m ofb_tpu_torch.scripts.make_imagefolder --root /tmp/imfolder ...
  python -m ofb_tpu_torch.scripts.data_bench --root /tmp/imfolder/train \
      [--n 2048]
"""

from __future__ import annotations

import argparse
import io
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--n", type=int, default=2048,
                    help="images per measurement")
    ap.add_argument("--staging", type=int, default=256)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args(argv)

    from PIL import Image

    from ..data.datasets import FolderDataset, resize_u8, scan_image_folder
    from ..data.native import (native_available, stage_jpeg,
                               stage_jpeg_batch)

    samples, _ = scan_image_folder(args.root)
    rs = np.random.RandomState(0)
    idx = rs.permutation(len(samples))[:args.n]
    paths = [samples[i][0] for i in idx]
    datas = []
    for p in paths:
        with open(p, "rb") as f:
            datas.append(f.read())
    mb = sum(len(d) for d in datas) / 1e6
    print(f"{len(datas)} JPEGs, {mb:.1f} MB compressed "
          f"({mb / len(datas) * 1000:.0f} KB avg)", flush=True)
    results = {}

    # PIL baseline: decode + resize-to-staging (the fallback path)
    t0 = time.perf_counter()
    for d in datas:
        resize_u8(Image.open(io.BytesIO(d)), args.staging)
    dt = time.perf_counter() - t0
    results["pil"] = len(datas) / dt
    print(f"PIL decode+stage:            {results['pil']:8.1f} img/s",
          flush=True)

    if not native_available():
        print("native library unavailable — stopping after PIL")
        print(json.dumps(results))
        return results

    # native, one image at a time (FolderDataset's per-item path)
    t0 = time.perf_counter()
    for d in datas:
        stage_jpeg(d, args.staging)
    dt = time.perf_counter() - t0
    results["native_1img"] = len(datas) / dt
    print(f"native single-image:         {results['native_1img']:8.1f} img/s",
          flush=True)

    # native threaded batch (the loader's batch staging path)
    for nt in args.threads:
        t0 = time.perf_counter()
        for s in range(0, len(datas), args.batch):
            stage_jpeg_batch(datas[s:s + args.batch], args.staging,
                             nthreads=nt)
        dt = time.perf_counter() - t0
        results[f"native_batch_t{nt}"] = len(datas) / dt
        print(f"native batch ({nt:2d} threads):   "
              f"{results[f'native_batch_t{nt}']:8.1f} img/s", flush=True)

    # end-to-end dataset path (open + read + decode + stage)
    ds = FolderDataset(args.root, args.staging)
    t0 = time.perf_counter()
    for i in idx[:min(args.n, 1024)]:
        ds[int(i)]
    dt = time.perf_counter() - t0
    results["folder_dataset"] = min(args.n, 1024) / dt
    print(f"FolderDataset end-to-end:    "
          f"{results['folder_dataset']:8.1f} img/s", flush=True)

    print(json.dumps({k: round(v, 1) for k, v in results.items()}),
          flush=True)
    return results


if __name__ == "__main__":
    main()
