"""Swin's window attention: a hand-written CUDA kernel pair and its plain
PyTorch versions.

No TPU kernel is replaced. The JAX package computes window attention as
plain jnp ops (ofb_tpu/models/swin.py `_window_attention`) and XLA fuses
the chain on the TPU. In eager PyTorch the chain (`models.swin.
window_softmax_attend` on a CPU tensor) writes and reads a full
(windows, heads, N, N) score tensor at each of its steps, forward and
backward, and keeps fp32 and bf16 copies of the probabilities for the
backward. The kernels (csrc/window_attention.cu) keep the scores in
registers: the forward reads q, k and v from the packed qkv rows once and
writes the output and the row log-sum-exp once; the backward reads q, k,
v, the output, its gradient and the log-sum-exp once and writes the
gradient of the packed qkv rows once. They are bound by those bytes.

`window_attention` is the function the models call on a CUDA tensor: an
autograd Function over the wrappers `window_attention_fwd` /
`window_attention_bwd`, which launch the kernels on a CUDA tensor (or
raise) and run the plain versions `window_attention_fwd_reference` /
`window_attention_bwd_reference` (the kernels' arithmetic) on a CPU one.
Each wrapper counts its launches in `.launches` and, by the input's type
('bf16', 'fp32'), in `.by_kind`.

The arithmetic. qkv (Bw, N, 3 H d) holds q, k and v of a token side by
side, head h at columns h d of each; window bw sits at position bw % nW of
its image. With S = scale q kᵀ (fp32 sums) + bias[h] (the (T, H) table
gathered through the (N N,) index) + mask[bw % nW] (none without a
mask), P = softmax(S) over a row in fp32 and lse = logsumexp(S):
out = P v with P rounded to qkv's type. Backward, from out, dout and lse:
P = exp(S - lse), delta = rowsum(dout out), dV = Pᵀ dout (P rounded),
dP = dout vᵀ, dS = P (dP - delta), dQ = (scale dS) k and
dK = (scale dS)ᵀ q (scale dS rounded), the table's gradient the sum of dS
over the windows gathered back through the index. The mask and the scale
get no gradient. Coverage: bf16 and fp32, N <= 64, head dims 1 to 64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

MAX_TOKENS = 64
MAX_HEAD_DIM = 64
_KINDS = {torch.bfloat16: "bf16", torch.float32: "fp32"}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(Bw, N, H d) -> (Bw, H, N, d)."""
    Bw, N, HD = x.shape
    return x.reshape(Bw, N, heads, HD // heads).transpose(1, 2)


def _split(qkv: torch.Tensor, heads: int):
    Bw, N, width = qkv.shape
    d = width // (3 * heads)
    return qkv.reshape(Bw, N, 3, heads, d).permute(2, 0, 3, 1, 4)


def _logits(q, k, scale, rel_bias, rel_idx, mask) -> torch.Tensor:
    """S (Bw, H, N, N) fp32."""
    Bw, H, N, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    s = s + rel_bias.float()[rel_idx.reshape(-1)].reshape(N, N, H).permute(
        2, 0, 1)
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(Bw // nW, nW, H, N, N) + mask.float()[None, :, None]
             ).reshape(Bw, H, N, N)
    return s


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).float()


def window_attention_fwd_reference(qkv, heads: int, scale, rel_bias, rel_idx,
                                   mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out (Bw, N, H d) in qkv's type,
    lse (Bw, H, N) fp32)."""
    q, k, v = _split(qkv, heads)
    s = _logits(q, k, scale, rel_bias, rel_idx, mask)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.matmul(_rounded(p, qkv.dtype), v.float()).to(qkv.dtype)
    Bw, N = qkv.shape[:2]
    return out.transpose(1, 2).reshape(Bw, N, -1), lse


def window_attention_bwd_reference(qkv, out, dout, lse, heads: int, scale,
                                   rel_bias, rel_idx, mask):
    """Plain version of the backward kernels: (dqkv (Bw, N, 3 H d) in qkv's
    type, the table's gradient (T, H) fp32) from qkv, the forward's out and
    lse, and dout."""
    dt = qkv.dtype
    q, k, v = (t.float() for t in _split(qkv, heads))
    o, do = _heads(out, heads).float(), _heads(dout, heads).float()
    s = _logits(q, k, scale, rel_bias, rel_idx, mask)
    p = torch.exp(s - lse[..., None])
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = torch.matmul(_rounded(p, dt).transpose(-2, -1), do)
    ds = p * (torch.matmul(do, v.transpose(-2, -1)) - delta)
    dss = _rounded(ds * scale, dt)
    dq = torch.matmul(dss, k)
    dk = torch.matmul(dss.transpose(-2, -1), q)
    Bw, H, N, d = q.shape
    dqkv = torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(
        Bw, N, 3 * H * d)
    dtable = torch.zeros(rel_bias.shape, dtype=torch.float32,
                         device=qkv.device)
    dtable.index_add_(0, rel_idx.reshape(-1),
                      ds.sum(dim=0).permute(1, 2, 0).reshape(N * N, H))
    return dqkv.to(dt), dtable


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def check_shape(shape, heads: int, dtype, nW: int = 1) -> Tuple[int, int]:
    """(N, d) of a qkv of `shape` (Bw, N, 3 heads d) and `dtype` that the
    kernels take (nW windows a mask); raises, naming the shape, for any
    other."""
    if dtype not in _KINDS:
        raise TypeError(f"window attention: the kernels take bfloat16 or "
                        f"float32, not {dtype}")
    if len(shape) != 3 or heads < 1 or shape[2] % (3 * heads):
        raise ValueError(f"window attention: qkv of shape {tuple(shape)} is "
                         f"no (windows, tokens, 3 x {heads} heads x d)")
    Bw, N, width = shape
    d = width // (3 * heads)
    if not (1 <= N <= MAX_TOKENS and 1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"window attention: qkv of shape {tuple(shape)} has "
                         f"{N} tokens and head dim {d}; the kernels take "
                         f"1 to {MAX_TOKENS} tokens and head dims 1 to "
                         f"{MAX_HEAD_DIM}")
    if nW < 1 or Bw % nW:
        raise ValueError(f"window attention: {Bw} windows are no multiple "
                         f"of the mask's {nW}")
    return N, d


def copy_width(d: int, itemsize: int, *ptrs: int) -> int:
    """Bytes a copy of a row chunk moves: the largest of 16, 8, 4 and 2 that
    divides the row's d elements and every pointer in `ptrs`."""
    vec = 16
    while vec > 2 and ((d * itemsize) % vec or any(p % vec for p in ptrs)):
        vec //= 2
    return vec


def padded_dim(d: int) -> int:
    """d rounded up to the bf16 kernels' depth (16)."""
    return -(-d // 16) * 16


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import load
    lib = load("window_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ofb_window_attn_grid.argtypes = [i] * 6
    lib.ofb_window_attn_fwd.argtypes = [p] * 7 + [f] + [i] * 10 + [p]
    lib.ofb_window_attn_bwd.argtypes = [p] * 8 + [f] + [p] * 4 + [i] * 11 \
        + [p]
    for fn in (lib.ofb_window_attn_grid, lib.ofb_window_attn_fwd,
               lib.ofb_window_attn_bwd):
        fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _chunks(which: int, device: int, bf16: int, dp: int, heads: int, nW: int,
            images: int) -> int:
    """Chunks of images a (head, window position) takes (0: forward, 1:
    backward); a host query made once a shape (before any capture)."""
    n = _lib().ofb_window_attn_grid(which, bf16, dp, heads, nW, images)
    if n < 1:
        raise RuntimeError(f"window attention: no grid for heads {heads}, "
                           f"positions {nW}, images {images} (code {n})")
    return n


def _operands(qkv, heads, scale, rel_bias, rel_idx, mask):
    """The checked call: (N, d, nW, table, idx, mask, scale pointer, scale
    value, bf16, dp) with the table, index and mask as the kernels read
    them."""
    if qkv.device.type != "cuda":
        raise RuntimeError(f"no window-attention kernel for device "
                           f"{qkv.device}")
    nW = 1 if mask is None else mask.shape[0]
    N, d = check_shape(qkv.shape, heads, qkv.dtype, nW)
    table = rel_bias.float().contiguous()
    idx = rel_idx.reshape(-1).long().contiguous()
    if table.dim() != 2 or table.shape[1] != heads or idx.numel() != N * N:
        raise ValueError(f"window attention: a bias table of shape "
                         f"{tuple(rel_bias.shape)} and {idx.numel()} indices "
                         f"for {heads} heads of {N} tokens")
    if mask is not None:
        if tuple(mask.shape) != (nW, N, N):
            raise ValueError(f"window attention: a mask of shape "
                             f"{tuple(mask.shape)} for {N} tokens")
        mask = mask.float().contiguous()
    for t in (table, idx, mask):
        if t is not None and t.device != qkv.device:
            raise ValueError("window attention: the bias, index and mask "
                             f"must be on {qkv.device}, not {t.device}")
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1 or scale.device != qkv.device:
            raise ValueError(f"window attention: a scale of shape "
                             f"{tuple(scale.shape)} on {scale.device}")
        sptr, sval = scale.float().reshape(1), 0.0
    else:
        sptr, sval = None, float(scale)
    bf16 = int(qkv.dtype == torch.bfloat16)
    return N, d, nW, table, idx, mask, sptr, sval, bf16, padded_dim(d)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _count(wrapper, dtype):
    wrapper.launches += 1
    wrapper.by_kind[_KINDS[dtype]] += 1


def window_attention_fwd(qkv, heads: int, scale, rel_bias, rel_idx, mask):
    """(out (Bw, N, H d), lse (Bw, H, N) fp32) of the window attention of a
    contiguous qkv (Bw, N, 3 H d). CUDA tensors: the forward kernel; CPU
    tensors: the plain version."""
    if qkv.device.type == "cpu":
        return window_attention_fwd_reference(qkv, heads, scale, rel_bias,
                                              rel_idx, mask)
    N, d, nW, table, idx, mask, sptr, sval, bf16, dp = _operands(
        qkv, heads, scale, rel_bias, rel_idx, mask)
    qkv = qkv.contiguous()
    Bw = qkv.shape[0]
    out = torch.empty((Bw, N, heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((Bw, heads, N), dtype=torch.float32, device=qkv.device)
    es = qkv.element_size()
    chunks = _chunks(0, qkv.device.index or 0, bf16, dp, heads, nW, Bw // nW)
    rc = _lib().ofb_window_attn_fwd(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), table.data_ptr(),
        idx.data_ptr(), _ptr(mask), _ptr(sptr), sval, Bw, N, heads, d, nW,
        chunks, copy_width(d, es, qkv.data_ptr()),
        copy_width(d, es, out.data_ptr()), bf16, dp,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"window-attention forward kernel failed: code "
                           f"{rc} (qkv {tuple(qkv.shape)}, heads {heads})")
    _count(window_attention_fwd, qkv.dtype)
    return out, lse


def window_attention_bwd(qkv, out, dout, lse, heads: int, scale, rel_bias,
                         rel_idx, mask):
    """(dqkv (Bw, N, 3 H d), the table's gradient (T, H) fp32) from qkv, the
    forward's out and lse, and dout. One call is one launch in the count
    (three kernels on the card). CUDA tensors: the backward kernels; CPU
    tensors: the plain version."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, out, dout, lse, heads,
                                              scale, rel_bias, rel_idx, mask)
    N, d, nW, table, idx, mask, sptr, sval, bf16, dp = _operands(
        qkv, heads, scale, rel_bias, rel_idx, mask)
    Bw = qkv.shape[0]
    if dout.shape != out.shape or out.shape != (Bw, N, heads * d) \
            or {dout.dtype, out.dtype} != {qkv.dtype} \
            or lse.shape != (Bw, heads, N) or lse.dtype != torch.float32:
        raise ValueError("window attention: out and dout must be (windows, "
                         "tokens, heads x d) of qkv's type, lse (windows, "
                         "heads, tokens) fp32")
    qkv, out, dout, lse = (t.contiguous() for t in (qkv, out, dout, lse))
    chunks = _chunks(1, qkv.device.index or 0, bf16, dp, heads, nW, Bw // nW)
    dqkv = torch.empty_like(qkv)
    partial = torch.empty((heads * nW * chunks, N * N), dtype=torch.float32,
                          device=qkv.device)
    dB = torch.empty((heads, N * N), dtype=torch.float32, device=qkv.device)
    dtable = torch.empty(table.shape, dtype=torch.float32, device=qkv.device)
    es = qkv.element_size()
    rc = _lib().ofb_window_attn_bwd(
        qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        table.data_ptr(), idx.data_ptr(), _ptr(mask), _ptr(sptr), sval,
        dqkv.data_ptr(), partial.data_ptr(), dB.data_ptr(), dtable.data_ptr(),
        Bw, N, heads, d, nW, table.shape[0], chunks,
        copy_width(d, es, qkv.data_ptr(), dqkv.data_ptr()),
        copy_width(d, es, out.data_ptr(), dout.data_ptr()), bf16, dp,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"window-attention backward kernels failed: code "
                           f"{rc} (qkv {tuple(qkv.shape)}, heads {heads})")
    _count(window_attention_bwd, qkv.dtype)
    return dqkv, dtable


_WRAPPERS = (window_attention_fwd, window_attention_bwd)


def reset_launch_counts():
    for wrapper in _WRAPPERS:
        wrapper.launches = 0
        wrapper.by_kind = dict.fromkeys(_KINDS.values(), 0)


reset_launch_counts()


def launch_counts():
    """{(wrapper name, kind): launches} of both wrappers."""
    return {(w.__name__, k): n for w in _WRAPPERS
            for k, n in w.by_kind.items()}


def add_launches(counts):
    """Add {(wrapper name, kind): n} to the counts (a CUDA graph's replay,
    `core.steps.PlannedStep`)."""
    wrappers = {w.__name__: w for w in _WRAPPERS}
    for (name, kind), n in counts.items():
        wrappers[name].launches += n
        wrappers[name].by_kind[kind] += n


class _WindowAttention(torch.autograd.Function):
    """The window attention's custom gradient: saves qkv, the output and
    the row log-sum-exp (no score tensor); the table's gradient is handed
    back in the table's type."""

    @staticmethod
    def forward(ctx, qkv, rel_bias, heads, scale, rel_idx, mask):
        out, lse = window_attention_fwd(qkv, heads, scale, rel_bias, rel_idx,
                                        mask)
        scale_t = scale if isinstance(scale, torch.Tensor) else None
        ctx.save_for_backward(qkv, out, lse, rel_bias, rel_idx, mask, scale_t)
        ctx.heads, ctx.scale = heads, None if scale_t is not None else scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse, rel_bias, rel_idx, mask, scale_t = ctx.saved_tensors
        scale = scale_t if scale_t is not None else ctx.scale
        dqkv, dtable = window_attention_bwd(qkv, out, dout, lse, ctx.heads,
                                            scale, rel_bias, rel_idx, mask)
        return dqkv, dtable.to(rel_bias.dtype), None, None, None, None


def window_attention(qkv, heads: int, scale, rel_bias, rel_idx,
                     mask=None) -> torch.Tensor:
    """qkv (Bw, N, 3 heads d) -> (Bw, N, heads d) through the kernel pair
    (the plain versions on a CPU tensor); `scale` a float or a one-element
    fp32 tensor on qkv's device, `mask` (nW, N, N) or None."""
    return _WindowAttention.apply(qkv, rel_bias, heads, scale, rel_idx, mask)
