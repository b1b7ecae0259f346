"""The file-list dataset and forever iterator (ofb_tpu_torch/data/file_list.py)
and `NativeFolderDataset` (ofb_tpu_torch/data/native.py) against ofb_tpu's
on the same temporary files, on the CPU.

`parse_image_list` gives the same (path, label) pairs; `ImageList` and
`NativeFolderDataset` give the same staged uint8 images (bit-equal: the
same PIL resize, or the same native library source) and labels;
`ForeverDataIterator` gives the same endless sequence and epoch count.
Each package builds its own copy of the native library at first use, as
tests/test_native.py has JAX's do; the cases that stage JPEGs natively
skip where neither copy can be built, and the PIL path runs regardless.
"""

import io
import os

import numpy as np
import pytest

from ofb_tpu.data import file_list as JF
from ofb_tpu.data import native as JN
from ofb_tpu_torch.data import file_list as F
from ofb_tpu_torch.data import native as N


def _write_images(root):
    """A small ImageFolder: JPEGs, a PNG and a non-square image, in two
    classes and a nested directory; and a list file over them."""
    from PIL import Image
    rng = np.random.default_rng(0)
    files = [("cat/a.jpg", (40, 56)), ("cat/deep/b.jpeg", (64, 48)),
             ("dog/c.png", (30, 30)), ("dog/d.jpg", (72, 33))]
    for rel, (w, h) in files:
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        base = rng.uniform(0, 1, (4, 4, 3))
        img = (np.kron(base, np.ones((h // 4 + 1, w // 4 + 1, 1)))[:h, :w]
               * 255).astype(np.uint8)
        Image.fromarray(img).save(path, "PNG" if rel.endswith(".png")
                                  else "JPEG", quality=92)
    (root / "list.txt").write_text(
        "cat/a.jpg 3\n\ndog/c.png 1\ncat/deep/b.jpeg\n dog/d.jpg 7 \n")
    return files


def test_parse_image_list_matches(tmp_path):
    _write_images(tmp_path)
    for root in ("", str(tmp_path), "/data"):
        got = F.parse_image_list(str(tmp_path / "list.txt"), root=root)
        assert got == JF.parse_image_list(str(tmp_path / "list.txt"),
                                          root=root)
    assert [t for _, t in got] == [3, 1, 0, 7]
    assert got[0] == ("/data/cat/a.jpg", 3)


@pytest.mark.parametrize("staging", [24, 40])
def test_image_list_matches(tmp_path, staging):
    _write_images(tmp_path)
    mine = F.ImageList(str(tmp_path / "list.txt"), staging=staging,
                       root=str(tmp_path))
    theirs = JF.ImageList(str(tmp_path / "list.txt"), staging=staging,
                          root=str(tmp_path))
    assert len(mine) == len(theirs) == 4
    assert mine.samples == theirs.samples and mine.classes == theirs.classes
    for i in range(len(mine)):
        (a, ta), (b, tb) = mine[i], theirs[i]
        assert ta == tb and a.dtype == b.dtype == np.uint8
        assert a.shape == (staging, staging, 3)
        np.testing.assert_array_equal(a, b)
    # a list of samples in place of a file
    pairs = mine.samples[:2]
    assert F.ImageList(pairs, staging=staging).samples == pairs


def test_forever_iterator_matches():
    def factory(epoch):
        return iter([[epoch, 0], [epoch, 1], [epoch, 2]])
    for start in (0, 5):
        mine = F.ForeverDataIterator(factory, start_epoch=start)
        theirs = JF.ForeverDataIterator(factory, start_epoch=start)
        got = [next(mine) for _ in range(8)]
        assert got == [next(theirs) for _ in range(8)]
        assert got[3] == [start + 1, 0] and mine.epoch == theirs.epoch
    plain = F.ForeverDataIterator([1, 2])
    assert [next(plain) for _ in range(5)] == [1, 2, 1, 2, 1]
    assert iter(plain) is plain and plain.epoch == 2
    with pytest.raises(StopIteration):
        next(F.ForeverDataIterator(lambda e: iter([])))


@pytest.mark.parametrize("native", [True, False])
def test_native_folder_dataset_matches(tmp_path, monkeypatch, native):
    """With the library both packages stage the JPEGs natively (the PNG
    through PIL); without it (`stage_jpeg` returning None) every image goes
    through PIL."""
    _write_images(tmp_path)
    if native:
        if not (N.native_available() and JN.native_available()):
            pytest.skip("the native library cannot be built here")
    else:
        monkeypatch.setattr(N, "stage_jpeg", lambda data, staging: None)
        monkeypatch.setattr(JN, "stage_jpeg", lambda data, staging: None)
    mine = N.NativeFolderDataset(str(tmp_path), 32)
    theirs = JN.NativeFolderDataset(str(tmp_path), 32)
    assert len(mine) == len(theirs) == 4 and mine.samples == theirs.samples
    assert [t for _, t in mine.samples] == [0, 0, 1, 1]
    for i in range(len(mine)):
        (a, ta), (b, tb) = mine[i], theirs[i]
        assert ta == tb and a.shape == b.shape == (32, 32, 3)
        np.testing.assert_array_equal(a, b)
    if native:
        # the JPEGs were staged by the library, not by PIL
        from PIL import Image
        from ofb_tpu_torch.data.datasets import resize_u8
        path = mine.samples[0][0]
        with open(path, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(mine[0][0], N.stage_jpeg(data, 32))
        pil = resize_u8(Image.open(io.BytesIO(data)), 32)
        assert np.abs(mine[0][0].astype(int) - pil.astype(int)).mean() < 6
