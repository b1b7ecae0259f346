"""ctypes bindings for the native data-prep library (native/ofb_dataprep.cpp).

Port of ofb_tpu/data/native.py. The library is built at first use with
`g++` from the repo's source into `build/ofb_tpu_torch/` (a file name that
carries a hash of the source and flags); `native/` is only read. Without a
toolchain or libjpeg the functions return None and the datasets decode
with PIL instead. API: stage JPEG bytes to fixed-size uint8 HWC staging
images, one at a time or a threaded batch; `NativeFolderDataset`, an
ImageFolder whose images the library stages.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "ofb_dataprep.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ofb_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_state = {"tried": False, "lib": None}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libofb_dataprep-{h.hexdigest()[:12]}.so"


def _build() -> Optional[Path]:
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                        *LIBS], check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, path)
    return path


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.ofb_stage_jpeg.restype = ctypes.c_int
        lib.ofb_stage_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_int, ctypes.c_void_p]
        lib.ofb_stage_jpeg_batch.restype = ctypes.c_int
        lib.ofb_stage_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        lib.ofb_resize_rgb.restype = None
        lib.ofb_resize_rgb.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int]
        _state["lib"] = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def stage_jpeg(data: bytes, staging: int) -> Optional[np.ndarray]:
    """One JPEG byte string -> (staging, staging, 3) uint8, or None on a
    decode failure or without the library."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((staging, staging, 3), np.uint8)
    rc = lib.ofb_stage_jpeg(data, len(data), staging,
                            out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


def stage_jpeg_batch(datas: Sequence[bytes], staging: int,
                     nthreads: int = 4) -> Optional[np.ndarray]:
    """JPEG byte strings -> (n, staging, staging, 3) uint8 on `nthreads`
    native threads; failed decodes come back zero-filled."""
    lib = _load()
    if lib is None:
        return None
    n = len(datas)
    out = np.empty((n, staging, staging, 3), np.uint8)
    arr_ptr = (ctypes.c_char_p * n)(*datas)
    arr_len = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    lib.ofb_stage_jpeg_batch(arr_ptr, arr_len, n, staging,
                             out.ctypes.data_as(ctypes.c_void_p), nthreads)
    return out


def resize_rgb(img: np.ndarray, dw: int, dh: int) -> Optional[np.ndarray]:
    """uint8 (h, w, 3) -> (dh, dw, 3) with the library's resize."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"resize_rgb wants (h, w, 3) uint8, got {img.shape}")
    sh, sw = img.shape[:2]
    out = np.empty((dh, dw, 3), np.uint8)
    lib.ofb_resize_rgb(img.ctypes.data_as(ctypes.c_void_p), sw, sh,
                       out.ctypes.data_as(ctypes.c_void_p), dw, dh)
    return out


class NativeFolderDataset:
    """ImageFolder over image files staged by the native library; an image
    it cannot decode (not a JPEG, or no library) goes through PIL."""

    def __init__(self, root: str, staging: int):
        from .datasets import scan_image_folder
        self.samples, _ = scan_image_folder(root)
        self.staging = staging

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, target = self.samples[i]
        with open(path, "rb") as f:
            data = f.read()
        arr = stage_jpeg(data, self.staging)
        if arr is None:
            from PIL import Image
            from .datasets import resize_u8
            arr = resize_u8(Image.open(io.BytesIO(data)), self.staging)
        return arr, target
