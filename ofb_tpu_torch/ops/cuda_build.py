"""Build and load the port's hand-written CUDA kernels.

Each source in `ofb_tpu_torch/csrc/` with a plain C interface is compiled
by `nvcc` into its own shared library for `sm_90a` and loaded with
`ctypes`. The build happens at first use, one `nvcc` per source, all
started together, into `build/ofb_tpu_torch/` at the root of the checkout
(git-ignored). A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ofb_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library name -> its source; every source also includes the headers
SOURCES = {
    "attention_fwd": "attention_fwd.cu",
    "attention_bwd": "attention_bwd.cu",
    "attention_fwd_resident": "attention_fwd_resident.cu",
    "attention_bwd_resident": "attention_bwd_resident.cu",
    "attention_fwd_streaming": "attention_fwd_streaming.cu",
    "attention_bwd_streaming": "attention_bwd_streaming.cu",
    "attention_fwd_unaligned": "attention_fwd_unaligned.cu",
    "attention_bwd_unaligned": "attention_bwd_unaligned.cu",
    "step_marks": "step_marks.cu",
    "layer_norm": "layer_norm.cu",
    "window_attention": "window_attention.cu",
}
_HEADERS = ("attention_common.cuh", "sm90.cuh", "sm90_tma.cuh")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile the named libraries that are not built yet, in parallel.
    Returns name -> path. Raises with the compiler's output on failure;
    the compiler's report (registers, spills) is kept beside each library
    as `<library>.log`."""
    names = list(names)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        todo[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use and loaded once."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
