"""Fused multi-head attention: hand-written CUDA kernels and their plain
PyTorch twins.

Port of ofb_tpu/ops/pallas_attention.py. The TPU kernel pair
(`_fwd_kernel`, `_bwd_kernel`) becomes `csrc/attention_fwd.cu` and
`csrc/attention_bwd.cu`; the custom VJP `_mha_pallas` becomes the
autograd Function `_FusedMHA`; `fused_mha` folds the (runtime) scale into q
in fp32 and calls it. Every attention call of the supernet goes through
here (models/vit.py `_attend`).

Dispatch is by device and nothing else: on a CUDA tensor the wrappers
`attention_fwd` / `attention_bwd` launch the kernels (or raise); on a CPU
tensor they run the plain twins `attention_fwd_reference` /
`attention_bwd_reference`, which repeat the kernels' arithmetic. Each
wrapper counts its launches in `.launches`.

Layout is the model's own (B, N, H, d) on both sides. q, k, v may be
strided views (the search step hands in views of the qkv buffer); the
kernels read them through their strides, and the outputs are contiguous.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _lib_fwd():
    from .cuda_build import load
    lib = load("attention_fwd")
    fn = lib.ofb_attention_fwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _lib_bwd():
    from .cuda_build import load
    lib = load("attention_bwd")
    fn = lib.ofb_attention_bwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def attention_fwd(q, k, v):
    """o, lse = softmax(q kᵀ) v and its row log-sum-exp, q pre-scaled.
    CUDA tensors: the forward kernel. CPU tensors: the plain twin."""
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {q.device}")
    B, N, H, d = _check(q, k, v)
    o = torch.empty((B, N, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    st = _strides(q, k, v)
    rc = _lib_fwd()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, N, H, d,
                    ctypes.cast(st, ctypes.c_void_p),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention forward kernel failed: CUDA error {rc}")
    attention_fwd.launches += 1
    return o, lse


def attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of o = softmax(q kᵀ) v. CUDA tensors: the backward
    kernels (o and lse from `attention_fwd`). CPU tensors: the plain twin,
    which recomputes p and ignores o and lse."""
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
    st = _strides(q, k, v, o, do)
    rc = _lib_bwd()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), B, N, H, d,
                    ctypes.cast(st, ctypes.c_void_p),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention backward kernels failed: CUDA error {rc}")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_fwd.launches = 0
attention_bwd.launches = 0


def reset_launch_counts():
    attention_fwd.launches = 0
    attention_bwd.launches = 0


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
