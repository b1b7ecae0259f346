"""The port's data path (ofb_tpu_torch/data) against ofb_tpu/data on the CPU:
samplers, datasets, the native JPEG staging, the host loader, the device
feed and the device cache.

Everything before the transform is exact: index plans bit-identical,
staged uint8 images byte-identical, raw feeds equal batch for batch in
the same (A, mb, ...) order. The eval transform is held to 5e-3 in the
0..255 domain (its resample sums in another order, see
test_torch_port_augment.py).
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from ofb_tpu import config as JCfg
from ofb_tpu.data import datasets as JD
from ofb_tpu.data import native as JN
from ofb_tpu.data import pipeline as JP
from ofb_tpu.data import samplers as JS
from ofb_tpu_torch import config as Cfg
from ofb_tpu_torch.data import datasets as D
from ofb_tpu_torch.data import native as N
from ofb_tpu_torch.data import pipeline as P
from ofb_tpu_torch.data import samplers as S

torch.set_num_threads(1)


@pytest.mark.parametrize("n,epoch,rank,world", [
    (1000, 0, 0, 1), (1000, 3, 1, 4), (1001, 7, 3, 4), (257, 2, 0, 2),
    (4096, 1, 5, 8), (10, 0, 1, 3)])
def test_samplers_bit_identical(n, epoch, rank, world):
    for shuffle in (True, False):
        for drop_last in (True, False):
            kw = dict(shuffle=shuffle, seed=5, drop_last=drop_last)
            assert np.array_equal(
                S.distributed_indices(n, epoch, rank, world, **kw),
                JS.distributed_indices(n, epoch, rank, world, **kw))
    for reps in (1, 3):
        a = S.ra_indices(n, epoch, rank, world, num_repeats=reps, seed=2)
        assert np.array_equal(a, JS.ra_indices(n, epoch, rank, world,
                                               num_repeats=reps, seed=2))
    for bs in (b for b in (1, 7, 64) if b <= len(a)):
        for drop_last in (True, False):
            assert np.array_equal(S.epoch_batches(a, bs, drop_last=drop_last),
                                  JS.epoch_batches(a, bs,
                                                   drop_last=drop_last))


def test_synthetic_dataset_byte_identical():
    dc = Cfg.DataConfig(data_set="SYNTHETIC", synthetic_size=70000,
                        synthetic_num_classes=17)
    jdc = JCfg.DataConfig(data_set="SYNTHETIC", synthetic_size=70000,
                          synthetic_num_classes=17)
    ds, nc = D.build_dataset(True, dc, staging=24)
    jds, jnc = JD.build_dataset(True, jdc, staging=24)
    assert (len(ds), nc) == (len(jds), jnc) == (70000, 17)
    for i in (0, 1, 16, 65535, 65536, 69999):
        (a, la), (b, lb) = ds[i], jds[i]
        assert a.dtype == np.uint8 and a.shape == (24, 24, 3)
        assert np.array_equal(a, b) and la == lb


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """Two classes of JPEGs and PNGs of several sizes."""
    from PIL import Image
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(0)
    for c, sizes in (("cat", [(50, 40), (33, 61)]), ("dog", [(64, 64)])):
        os.makedirs(root / "train" / c)
        for i, (w, h) in enumerate(sizes):
            im = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
            im.save(root / "train" / c / f"{i}.jpg", quality=90)
            im.save(root / "train" / c / f"{i}.png")
    return str(root / "train")


def test_native_stage_jpeg_matches_jax(image_folder):
    if not N.native_available():
        pytest.skip("no g++ / libjpeg to build native/ofb_dataprep.cpp")
    assert "build" in str(N.library_path())
    paths = [os.path.join(image_folder, c, f) for c in ("cat", "dog")
             for f in sorted(os.listdir(os.path.join(image_folder, c)))
             if f.endswith(".jpg")]
    datas = [open(p, "rb").read() for p in paths]
    for d in datas:
        a = N.stage_jpeg(d, 32)
        assert a is not None and np.array_equal(a, JN.stage_jpeg(d, 32))
    assert N.stage_jpeg(b"not a jpeg", 32) is None
    assert np.array_equal(N.stage_jpeg_batch(datas, 24, nthreads=2),
                          JN.stage_jpeg_batch(datas, 24, nthreads=2))
    img = np.random.default_rng(1).integers(0, 256, (20, 30, 3), np.uint8)
    assert np.array_equal(N.resize_rgb(img, 12, 9), JN.resize_rgb(img, 12, 9))


def test_folder_dataset_matches_jax(image_folder, tmp_path):
    samples, c2i = D.scan_image_folder(image_folder)
    jsamples, jc2i = JD.scan_image_folder(image_folder)
    assert samples == jsamples and c2i == jc2i and len(samples) == 6
    for native in (True, False):
        ds = D.FolderDataset(image_folder, 32, native_decode=native)
        jds = JD.FolderDataset(image_folder, 32, native_decode=native)
        for i in range(len(ds)):
            (a, la), (b, lb) = ds[i], jds[i]
            assert np.array_equal(a, b) and la == lb
    sub = D.FolderDataset(image_folder, 32, class_subset=[1])
    assert [t for _, t in sub.samples] == [0, 0]
    os.makedirs(tmp_path / "empty_class")
    with pytest.raises(FileNotFoundError):
        D.scan_image_folder(str(tmp_path))


def test_cifar_inat_and_digits_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    base = tmp_path / "cifar-10-batches-py"
    os.makedirs(base)
    with open(base / "test_batch", "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (5, 3072), np.uint8),
                     b"labels": [3, 1, 4, 1, 5]}, f)
    from PIL import Image
    imgs = []
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (30, 20, 3), np.uint8)).save(
            tmp_path / f"im{i}.jpg")
        imgs.append({"id": i, "file_name": f"im{i}.jpg"})
    cats = [{"id": 0, "name": "b"}, {"id": 1, "name": "a"}]
    for split in ("train", "val"):
        with open(tmp_path / f"{split}2018.json", "w") as f:
            json.dump({"images": imgs, "annotations": [
                {"image_id": 0, "category_id": 0},
                {"image_id": 1, "category_id": 1}]}, f)
    with open(tmp_path / "categories2018.json", "w") as f:
        json.dump(cats, f)
    for name, staging in (("CIFAR10", 32), ("CIFAR10", 40), ("INAT", 24),
                          ("DIGITS", 16)):
        dc = Cfg.DataConfig(data_set=name, data_path=str(tmp_path))
        jdc = JCfg.DataConfig(data_set=name, data_path=str(tmp_path))
        ds, nc = D.build_dataset(False, dc, staging)
        jds, jnc = JD.build_dataset(False, jdc, staging)
        assert nc == jnc and len(ds) == len(jds)
        for i in range(min(len(ds), 5)):
            (a, la), (b, lb) = ds[i], jds[i]
            assert np.array_equal(a, b) and la == lb, (name, i)
    with pytest.raises(ValueError):
        D.build_dataset(True, Cfg.DataConfig(data_set="MNIST"))


@pytest.mark.parametrize("workers", [0, 2])
def test_host_loader_batches_identical(workers, image_folder):
    ds = D.SyntheticDataset(300, 10, 16)
    for train, ra in ((True, True), (True, False), (False, False)):
        kw = dict(epoch=2, rank=0, world=1, batch_size=32, repeated_aug=ra,
                  train=train, seed=4, num_workers=workers)
        mine = list(P.make_epoch_loader(ds, **kw))
        theirs = list(JP.make_epoch_loader(ds, **kw))
        assert len(mine) == len(theirs) == len(P.make_epoch_loader(ds, **kw))
        for (a, la), (b, lb) in zip(mine, theirs):
            assert a.dtype == np.uint8 and la.dtype == np.int32
            assert np.array_equal(a, b) and np.array_equal(la, lb)
    # a folder of JPEGs goes through the native batch path on both sides
    fds = D.FolderDataset(image_folder, 24)
    jfds = JD.FolderDataset(image_folder, 24)
    plan = np.array([[0, 2], [4, 1]])
    for (a, la), (b, lb) in zip(P.HostLoader(fds, plan),
                                JP.HostLoader(jfds, plan)):
        assert np.array_equal(a, b) and np.array_equal(la, lb)


def test_raw_feeds_and_the_device_cache_agree_with_jax():
    ds = D.SyntheticDataset(200, 10, 20)
    kw = dict(epoch=1, rank=0, world=1, batch_size=24, repeated_aug=True,
              train=True, seed=3)
    jfeed = JP.device_feed(JP.make_epoch_loader(ds, **kw),
                           rng=jax.random.PRNGKey(0), train=True,
                           accum_iter=2, raw=True)
    feed = P.device_feed(P.make_epoch_loader(ds, **kw), train=True,
                         accum_iter=2, raw=True, device="cpu")
    cache, labels = P.build_device_cache(ds, chunk=64, device="cpu")
    assert cache.dtype == torch.uint8 and cache.shape == (200, 20, 20, 3)
    cfeed = P.device_cache_feed(cache, labels, accum_iter=2, raw=True, **kw)
    n = 0
    for (x, y), (cx, cy), (jx, jy) in zip(feed, cfeed, jfeed):
        assert x.shape == (2, 12, 20, 20, 3) and x.dtype == torch.uint8
        assert np.array_equal(x.numpy(), np.asarray(jx))
        assert np.array_equal(y.numpy(), np.asarray(jy))
        assert torch.equal(cx, x) and torch.equal(cy, y)
        n += 1
    assert n == len(P.make_epoch_loader(ds, **kw)) == 25


def test_eval_feeds_match_jax():
    ds = D.SyntheticDataset(20, 10, 40)
    kw = dict(epoch=0, rank=0, world=1, batch_size=8, repeated_aug=False,
              train=False, seed=0)
    jfeed = JP.device_feed(JP.make_epoch_loader(ds, **kw),
                           rng=jax.random.PRNGKey(0), train=False,
                           out_size=32)
    feed = P.device_feed(P.make_epoch_loader(ds, **kw), train=False,
                         out_size=32, device="cpu")
    cache, labels = P.build_device_cache(ds, device="cpu")
    cfeed = P.device_cache_feed(cache, labels, out_size=32, **kw)
    batches = list(zip(feed, cfeed, jfeed))
    assert len(batches) == 3                       # 20 images, last padded
    for (x, y), (cx, cy), (jx, jy) in batches:
        assert x.shape == (1, 8, 32, 32, 3) and x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                                   atol=5e-3 / 255 / 0.224)
        assert torch.equal(cx, x) and np.array_equal(y.numpy(),
                                                     np.asarray(jy))


def test_train_feed_draws_from_its_generator():
    ds = D.SyntheticDataset(64, 10, 40)
    kw = dict(epoch=0, rank=0, world=1, batch_size=16, repeated_aug=False,
              train=True, seed=0)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return [x for x, _ in P.device_feed(
            P.make_epoch_loader(ds, **kw), generator=g, train=True,
            accum_iter=2, out_size=32, device="cpu")]
    a, b, c = run(0), run(0), run(1)
    assert a[0].shape == (2, 8, 32, 32, 3) and a[0].dtype == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="generator"):
        next(P.device_feed(P.make_epoch_loader(ds, **kw), train=True,
                           device="cpu"))


def test_device_cache_refuses_above_max_bytes():
    ds = D.SyntheticDataset(10, 10, 16)
    with pytest.raises(ValueError, match="GiB"):
        P.build_device_cache(ds, max_bytes=10 * 16 * 16 * 3 - 1,
                             device="cpu")
    cache, labels = P.build_device_cache(ds, max_bytes=10 * 16 * 16 * 3,
                                         device="cpu")
    assert np.array_equal(labels, np.arange(10, dtype=np.int32))
    assert np.array_equal(cache[3].numpy(), ds[3][0])


def test_prefetched_keeps_order_and_runs_ahead():
    seen = []

    def gen():
        for i in range(6):
            seen.append(i)
            yield i
    out = []
    for v in P._prefetched(gen(), 2):
        out.append((v, len(seen)))
    assert [v for v, _ in out] == list(range(6))
    # when item i is handed out, items up to i + 2 have been produced
    assert [s for _, s in out] == [3, 4, 5, 6, 6, 6]
    assert [v for v in JP._prefetched(iter(range(6)), 2)] == list(range(6))


def test_synthetic_path_imports_neither_pil_nor_sklearn():
    """The card's machine has neither: the SYNTHETIC path, the feeds and
    the CLIs must not import them."""
    import subprocess
    import sys
    code = (
        "import sys, numpy as np\n"
        "from ofb_tpu_torch.cli import search, export, finetune, eval\n"
        "from ofb_tpu_torch.config import DataConfig\n"
        "from ofb_tpu_torch.data import datasets as D, pipeline as P\n"
        "ds, _ = D.build_dataset(True, DataConfig(data_set='SYNTHETIC',"
        " synthetic_size=8), 16)\n"
        "for x, y in P.device_feed(P.make_epoch_loader(ds, epoch=0, rank=0,"
        " world=1, batch_size=4, repeated_aug=False), train=False,"
        " out_size=8, device='cpu'):\n"
        "    pass\n"
        "bad = [m for m in ('PIL', 'sklearn') if m in sys.modules]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=300)
