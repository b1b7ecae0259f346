"""Fused multi-head attention: hand-written CUDA kernels and their plain
PyTorch twins.

Port of ofb_tpu/ops/pallas_attention.py. The TPU kernel pair
(`_fwd_kernel`, `_bwd_kernel`) becomes `csrc/attention_fwd.cu` and
`csrc/attention_bwd.cu`; the custom VJP `_mha_pallas` becomes the
autograd Function `_FusedMHA`; `fused_mha` folds the (runtime) scale into q
in fp32 and calls it. Every attention call of the supernet goes through
here (models/vit.py `_attend`).

Dispatch is by device: on a CUDA tensor the wrappers `attention_fwd` /
`attention_bwd` launch the kernels (or raise); on a CPU tensor they run the
plain twins `attention_fwd_reference` / `attention_bwd_reference`, which
repeat the kernels' arithmetic. Each wrapper counts its launches in
`.launches`, and per body in `.by_body`.

Two kernel bodies, both hand-written. `resident` (csrc/*_resident.cu) keeps
a whole head's K and V (or Q and dO) in shared memory and the scores in
`wgmma` registers; it takes bf16, up to 256 tokens, every head dim the
wrappers take (a multiple of 8 up to 128; 8 * odd ones, such as the 24, 40
and 56 of exported subnets, run zero-padded to the next multiple of 16 in
shared memory) and rows that start on 16 bytes. `general` (csrc/
attention_fwd.cu, attention_bwd.cu) tiles both sides and takes every shape
and type the wrappers accept; it serves what the resident body does not:
more than 256 tokens, unaligned views, fp32. `attention_body` picks one
from the shape, the type and the alignment alone; a body that fails to
build or launch raises, nothing reroutes.

Layout is the model's own (B, N, H, d) on both sides. q, k, v may be
strided views (the search step hands in views of the qkv buffer); the
kernels read them through their strides, and the outputs are contiguous.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448                 # bytes of shared memory a Hopper block may use


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def mha_reference_prescaled(q, k, v):
    """Twin of the JAX reference path `_mha_reference_prescaled`: softmax
    attention over (B, N, H, d) with q already scaled."""
    s = torch.einsum("bnhd,bmhd->bhnm", q, k).float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v)


def attention_fwd_reference(q, k, v):
    """Plain version of the forward kernel: (o, lse). Scores, max and sums
    in fp32; p rounded to v's type before p @ v (as `_fwd_kernel`); lse is
    the fp32 row log-sum-exp, (B, H, N)."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p = (e / l).to(v.dtype).float()
    o = torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)
    return o, (m + torch.log(l)).squeeze(-1)


def attention_bwd_reference(q, k, v, do):
    """Plain version of the backward kernels, the math of `_bwd_kernel`:
    (dq, dk, dv) for o = softmax(q kᵀ) v, no scale inside."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qf, kf), dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(*ts):
    """Validate tensors for the kernels; returns (B, N, H, d)."""
    q = ts[0]
    if q.dim() != 4:
        raise ValueError(f"attention expects (B, N, H, d) tensors, got {tuple(q.shape)}")
    B, N, H, d = q.shape
    if d % 8 != 0 or not 8 <= d <= 128:
        raise ValueError(f"head dim {d} is not a multiple of 8 in [8, 128]")
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention kernels take float32 or bfloat16, not {q.dtype}")
    for t in ts:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v (and o, do) must share shape, dtype and device")
        if t.stride(-1) != 1:
            raise ValueError("the head dim must be contiguous (stride 1)")
    return B, N, H, d


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


class Body(NamedTuple):
    """What `attention_body` decides: the kernel body, the key count its
    forward pads to, and the dynamic shared memory (bytes) its forward and
    its two backward kernels ask for; zeros for the general body, whose C
    launchers size their own tiles."""
    name: str
    padded_keys: int
    smem_fwd: int
    smem_bwd: int


def _aligned16(t) -> bool:
    """Whether every row of the (B, N, H, d) bf16 view starts on 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def attention_body(N: int, d: int, dtype, aligned: bool = True) -> Body:
    """Which kernel body serves (N tokens, head dim d, dtype), from the
    shape, the type and the rows' 16-byte alignment alone: bf16, 1 <= N <=
    256, d a multiple of 8 in [8, 128] and aligned rows take the resident
    body. Its numbers repeat the arithmetic of csrc/attention_*_resident.cu:
    the forward's keys padded to 64 * ceil(N / 64), or to 208 for
    192 < N <= 208; tiles of 64 head-dim columns when d16 = 16 * ceil(d /
    16) <= 64, else 128; 1024 bytes of alignment slack. The backward is one
    fused kernel for d16 <= 64 (q, k, v, do, o in whole 64-row tiles, three
    output stages, lse and delta) and a dq and a dk/dv kernel above (the
    resident side padded to 16)."""
    if dtype != torch.bfloat16 or not 1 <= N <= 256 or d % 8 != 0 \
            or not 8 <= d <= 128 or not aligned:
        return Body("general", 0, 0, 0)
    dp = 64 if d <= 64 else 128                          # d16 <= 64
    tile = 64 * dp * 2                                   # 64 rows, bf16
    rows64 = 64 * -(-N // 64)                            # whole 64-row tiles
    keys = 208 if 192 < N <= 208 else rows64
    fwd = 2 * keys * dp * 2 + 2 * tile + 1024            # k, v; 2 q buffers
    if dp == 64:
        bwd = 5 * rows64 * 128 + 3 * tile + 2 * rows64 * 4 + 1024
    else:
        rows16 = 16 * -(-N // 16)
        dq = 2 * rows16 * dp * 2 + 5 * tile + 2 * 64 * 4 + 1024
        dkdv = 2 * rows16 * dp * 2 + 4 * tile + 2 * rows16 * 4 + 1024
        bwd = max(dq, dkdv)
    return Body("resident", keys, fwd, bwd)


_ENTRIES = {
    # library and C entry, number of tensor pointers, whether dtype leads
    ("fwd", "general"): ("attention_fwd", "ofb_attention_fwd", 5, True),
    ("bwd", "general"): ("attention_bwd", "ofb_attention_bwd", 10, True),
    ("fwd", "resident"): ("attention_fwd_resident",
                          "ofb_attention_fwd_resident", 5, False),
    ("bwd", "resident"): ("attention_bwd_resident",
                          "ofb_attention_bwd_resident", 10, False),
}


@functools.lru_cache(maxsize=None)
def _entry(which: str, body: str):
    """The C entry of a body, its library built and loaded at first use."""
    from .cuda_build import load
    lib, name, nptr, with_dtype = _ENTRIES[which, body]
    fn = getattr(load(lib), name)
    fn.argtypes = ([ctypes.c_int] if with_dtype else []) \
        + [ctypes.c_void_p] * nptr + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, which: str, body, tensors, outs, dims):
    """Pick the body (or take the one asked for), call its C entry, raise
    on a refusal or a CUDA error, count the launch."""
    q = tensors[0]
    fit = attention_body(dims[1], dims[3], q.dtype,
                         all(_aligned16(t) for t in tensors)).name
    if body is None:
        body = fit
    if (which, body) not in _ENTRIES:
        raise ValueError(f"no attention body {body!r}")
    if body == "resident" and fit != "resident":
        raise ValueError(f"the resident attention body does not take shape "
                         f"{tuple(q.shape)}, {q.dtype}, strides {q.stride()}")
    st = _strides(*tensors)
    args = [t.data_ptr() for t in tensors + outs] + list(dims) + [
        ctypes.cast(st, ctypes.c_void_p),
        torch.cuda.current_stream(q.device).cuda_stream]
    if body == "general":
        args.insert(0, _DTYPES[q.dtype])
    rc = _entry(which, body)(*args)
    if rc == -1:
        raise ValueError(f"the {body} attention body does not take shape "
                         f"{tuple(q.shape)}, {q.dtype}, strides {q.stride()}")
    if rc != 0:
        raise RuntimeError(f"attention {which} kernel ({body}) failed: "
                           f"CUDA error {rc}")
    wrapper.launches += 1
    wrapper.by_body[body] += 1


def attention_fwd(q, k, v, body=None):
    """o, lse = softmax(q kᵀ) v and its row log-sum-exp, q pre-scaled.
    CUDA tensors: the forward kernel, the body `attention_body` picks or
    the one named (which raises on a shape it does not take). CPU tensors:
    the plain twin."""
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {q.device}")
    B, N, H, d = _check(q, k, v)
    o = torch.empty((B, N, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    _launch(attention_fwd, "fwd", body, [q, k, v], [o, lse], (B, N, H, d))
    return o, lse


def attention_bwd(q, k, v, o, lse, do, body=None):
    """(dq, dk, dv) of o = softmax(q kᵀ) v. CUDA tensors: the backward
    kernels (o and lse from `attention_fwd`), body as in `attention_fwd`;
    one call is one launch in the count. CPU tensors: the plain twin, which
    recomputes p and ignores o and lse."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, do)
    if q.device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {q.device}")
    B, N, H, d = _check(q, k, v, o, do)
    if lse.shape != (B, H, N) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("lse must be contiguous float32 (B, H, N) on q's device")
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty((B, N, H, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    _launch(attention_bwd, "bwd", body, [q, k, v, o, do],
            [lse, delta, dq, dk, dv], (B, N, H, d))
    return dq, dk, dv


def reset_launch_counts():
    for wrapper in (attention_fwd, attention_bwd):
        wrapper.launches = 0
        wrapper.by_body = {"resident": 0, "general": 0}


reset_launch_counts()


class _FusedMHA(torch.autograd.Function):
    """Custom gradient of attention with q pre-scaled (the port of
    `_mha_pallas`). Saves the scaled q, k, v, the output and its row
    log-sum-exp; the gradient through the scale multiply is autograd's."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        return attention_bwd(q, k, v, o, lse, do)


def fused_mha(q, k, v, scale):
    """Softmax attention over (B, N, H, d); `scale` (a float or a 0-d
    tensor, rewritten at prune events) is folded into q in fp32 and cast
    back, as the JAX `fused_mha` does; the kernels are scale-free."""
    q = (q.float() * scale).to(q.dtype)
    return _FusedMHA.apply(q, k, v)
