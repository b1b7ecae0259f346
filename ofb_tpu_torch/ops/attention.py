"""Fused multi-head attention: hand-written CUDA kernels and their plain
PyTorch twins.

Port of ofb_tpu/ops/pallas_attention.py. The TPU kernel pair
(`_fwd_kernel`, `_bwd_kernel`) becomes the three kernel bodies below
(`csrc/attention_{fwd,bwd}*.cu`); the custom VJP `_mha_pallas` becomes the
autograd Function `_FusedMHA`; `fused_mha` folds the (runtime) scale into q
in fp32 and calls it. Every attention call of the supernet goes through
here (models/vit.py `_attend`).

Dispatch is by device: on a CUDA tensor the wrappers `attention_fwd` /
`attention_bwd` launch the kernels (or raise); on a CPU tensor they run the
plain twins `attention_fwd_reference` / `attention_bwd_reference`, which
repeat the kernels' arithmetic. Each wrapper counts its launches in
`.launches`, and per body in `.by_body`.

Four kernel bodies, all hand-written. `resident` (csrc/*_resident.cu)
keeps a whole head's K and V (or Q and dO) in shared memory and the scores
in `wgmma` registers; it takes bf16, up to 256 tokens, head dims that are a
multiple of 8 up to 128 (8 * odd ones, such as the 24, 40 and 56 of
exported subnets, run zero-padded to the next multiple of 16 in shared
memory) and rows that start on 16 bytes. `streaming` (csrc/
*_streaming.cu, sm90_tma.cuh) runs a persistent block an SM: a producer
warp loads 128 query rows (or keys) of a head and streams the other side
by TMA through an mbarrier ring, and two consumer warpgroups run `wgmma`
(taking turns in the backward), with an online softmax in registers; it
takes what the resident body takes at any token count and serves more than
256 tokens (DeiT at 384 pixels: 577). Its tensor maps are encoded at every
call from the call's own pointers through the driver's
cuTensorMapEncodeTiled; a refused map raises. `unaligned`
(csrc/*_unaligned.cu) serves the bf16 calls the other two do not take:
head dims off multiples of 8 (the search grids' 12, 20, 36, .., the heads
a narrow-head search exports) and views whose rows do not start on 16
bytes, at any token count and any head dim in [1, 128]. A block is one
warpgroup on 64 rows, streaming the other side in 64-row tiles through
`cp.async` double buffers of 16-, 8- or 4-byte copies (rows that start on
2 bytes only are staged as the aligned 16-byte chunks that hold them and
shifted into place in shared memory), `wgmma` products with the scores
and the sums in registers; its backward is a dq and a dk/dv kernel. `general` (csrc/attention_fwd.cu, attention_bwd.cu) is fp32
only, at every shape, view and head dim in [1, 128] (FMA on the CUDA
cores: register tiles of scores, 8 x 8 in the forward and 4 x 8 in the
backward, the streamed side double-buffered by cp.async). `attention_body`
picks one from the shape, the type and the alignment alone; a body that
fails to build or launch raises, nothing reroutes.

Layout is the model's own (B, N, H, d) on both sides. q, k, v may be
strided views (the search step hands in views of the qkv buffer); the
kernels read them through their strides, and the outputs are contiguous.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

_DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM = 232448                 # bytes of shared memory a Hopper block may use
# return codes of the streaming entries beyond CUDA's (csrc/sm90_tma.cuh)
_ENCODE_FAILED, _NO_ENCODER = 1000, 2000


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
    if not 1 <= d <= 128:
        raise ValueError(f"head dim {d} is not in [1, 128]")
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
    its backward kernels (the larger of two) ask for."""
    name: str
    padded_keys: int
    smem_fwd: int
    smem_bwd: int


def _aligned16(t) -> bool:
    """Whether every row of the (B, N, H, d) bf16 view starts on 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def attention_body(N: int, d: int, dtype, aligned: bool = True) -> Body:
    """Which kernel body serves (N tokens, head dim d, dtype), from the
    shape, the type and the rows' 16-byte alignment alone: bf16, d a
    multiple of 8 in [8, 128] and aligned rows take the resident body for
    1 <= N <= 256 and the streaming body above; every other bf16 call the
    unaligned body (`_unaligned_body`); fp32 the general body. The numbers
    repeat the arithmetic of csrc/attention_*_resident.cu
    (tiles of 64 head-dim columns when d16 = 16 * ceil(d / 16) <= 64, else
    128) and csrc/attention_*_streaming.cu (`_streaming_body`); 1024 bytes
    of alignment slack.
    The resident forward pads the keys to 64 * ceil(N / 64), or to 208 for
    192 < N <= 208; its backward is one fused kernel for d16 <= 64 (q, k, v,
    do, o in whole 64-row tiles, three output stages, lse and delta) and a
    dq and a dk/dv kernel above (the resident side padded to 16). The
    streaming body's count is 64 * ceil(N / 64), the tiles its backward
    walks (its forward walks 128-key tiles, the last one narrow when it
    holds up to 16 keys); the unaligned and the general bodies walk tiles
    of 64 too."""
    if dtype != torch.bfloat16:
        return _general_body(N, d)
    if N < 1 or d % 8 != 0 or not 8 <= d <= 128 or not aligned:
        return _unaligned_body(N, d)
    dp = 64 if d <= 64 else 128                          # d16 <= 64
    tile = 64 * dp * 2                                   # 64 rows, bf16
    rows64 = 64 * -(-N // 64)                            # whole 64-row tiles
    if N > 256:
        return _streaming_body(rows64, d)
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


def _unaligned_body(N: int, d: int) -> Body:
    """The unaligned body's shared memory (csrc/attention_*_unaligned.cu):
    64-row tiles of DP = 64 columns (d16 = 16 * ceil(d / 16) <= 64) or 128
    (above), bf16, and 1024 bytes of alignment slack. A streamed operand
    holds a tile and a second slot: its next tile (rows on 16 bytes) or
    the staging area of its next tile (64 rows of DP / 8 + 1 aligned
    16-byte chunks; csrc/sm90.cuh `stage_rows_async`). The forward holds q
    and streams k and v; the dq kernel holds q and do and streams k and v
    (o passes through a k slot that the first key tile leaves free), with
    the lse and delta of its 64 rows; the dk/dv kernel holds k and v and streams q and do, with the
    lse and delta of two query tiles. Keys walk in tiles of 64."""
    dp = 64 if d <= 64 else 128
    tile = 64 * dp * 2
    slot = max(tile, 64 * (dp // 8 + 1) * 16)
    fwd = tile + 2 * (tile + slot) + 1024
    bwd = 2 * tile + 2 * (tile + slot) + 4 * 64 * 4 + 1024
    return Body("unaligned", 64 * -(-N // 64), fwd, bwd)


def _general_body(N: int, d: int) -> Body:
    """The general body, fp32 (csrc/attention_common.cuh
    `f32_smem_*`): fp32 tiles of DP = 32 * ceil(d / 32) columns, keys (or
    queries) streamed in tiles of 64. The forward keeps 128 query rows
    resident for DP <= 64, else 64, with k and v double-buffered and p of
    half a key tile (rows x 32); the backward kernels keep 64 rows
    resident: the dq kernel q and do, k and v double-buffered and a 64 x 64
    ds tile; the dk/dv kernel k and v, q and do double-buffered with their
    lse and delta (4 x 64) and a 64 x 64 p / ds tile."""
    dp = 32 * -(-d // 32)
    bm = 128 if dp <= 64 else 64
    fwd = 4 * (bm * dp + 4 * 64 * dp + bm * 32)
    dq = 4 * (2 * 64 * dp + 4 * 64 * dp + 64 * 64)
    return Body("general", 64 * -(-N // 64), fwd, dq + 4 * 4 * 64)


def streaming_tail(d: int) -> int:
    """Columns of the streaming body's tail panel for head dim d: its tiles
    are a 64-column panel and, for d16 = 16 * ceil(d / 16) above 64, a tail
    of 16 (d16 = 80, ViT-H/14's d = 80), 32 (96) or 64 columns (112, 128),
    each with its own TMA box and swizzle (csrc/sm90_tma.cuh `tail_width`)."""
    d16 = 16 * -(-d // 16)
    return 0 if d16 <= 64 else 16 if d16 == 80 else 32 if d16 == 96 else 64


def _streaming_body(keys: int, d: int) -> Body:
    """The streaming body's shared memory (csrc/attention_*_streaming.cu):
    tiles of 64 (or 128) rows of 64 + tail columns (`streaming_tail`),
    8-byte mbarriers, 1024 bytes of alignment slack. The forward holds two
    query buffers of two 64-row tiles (one a consumer warpgroup) and a ring
    of K, V stages of 128 keys (four at d16 <= 80, three at 96, two at 128;
    4 + 3 a stage barriers). The dq kernel holds q, do and o of both
    consumers in two buffers (one at a tail of 64) and a ring of 64-key K,
    V stages (six at d16 <= 64, four at 80, else three; 4 + 2 a stage
    barriers); the dk/dv kernel k and v of both consumers in as many
    buffers and a ring of Q, dO and their 64 lse and delta (1024 bytes; 8
    stages at d16 <= 64, 6 at 80, else 4)."""
    tw = streaming_tail(d)
    tile = 64 * 2 * (64 + tw)
    buffers = 2 if tw <= 32 else 1
    fwd_stages = 4 if tw <= 16 else 3 if tw == 32 else 2
    dq_stages = 6 if tw == 0 else 4 if tw == 16 else 3
    kv_stages = 8 if tw == 0 else 6 if tw == 16 else 4
    fwd = tile * 2 * 2 + 2 * tile * 2 * fwd_stages \
        + 8 * (4 + 3 * fwd_stages) + 1024
    dq = tile * (3 * 2 * buffers + 2 * dq_stages) \
        + 8 * (4 + 2 * dq_stages) + 1024
    dkdv = tile * 2 * 2 * buffers + (2 * tile + 1024) * kv_stages \
        + 8 * (4 + 2 * kv_stages) + 1024
    return Body("streaming", keys, fwd, max(dq, dkdv))


BODIES = ("resident", "streaming", "unaligned", "general")
# each body's library (attention_fwd, attention_fwd_resident, ..: no suffix
# for the general body), whose C entry is "ofb_" + its name, and the number
# of tensor pointers the entry takes
_ENTRIES = {
    (which, body): ("attention_" + which + ("" if body == "general"
                                            else "_" + body), nptr)
    for which, nptr in (("fwd", 5), ("bwd", 10)) for body in BODIES}


@functools.lru_cache(maxsize=None)
def _entry(which: str, body: str):
    """The C entry of a body, its library built and loaded at first use."""
    from .cuda_build import load
    lib, nptr = _ENTRIES[which, body]
    fn = getattr(load(lib), "ofb_" + lib)
    fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * 4 \
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
    # the streaming body takes the resident body's shapes at any N, the
    # unaligned body every bf16 call, the general body every fp32 call
    takes = {"resident": ("resident",), "streaming": ("resident", "streaming"),
             "unaligned": ("resident", "streaming", "unaligned"),
             "general": ("general",)}[body]
    if fit not in takes:
        raise ValueError(f"the {body} attention body does not take shape "
                         f"{tuple(q.shape)}, {q.dtype}, strides {q.stride()}")
    st = _strides(*tensors)
    args = [t.data_ptr() for t in tensors + outs] + list(dims) + [
        ctypes.cast(st, ctypes.c_void_p),
        torch.cuda.current_stream(q.device).cuda_stream]
    rc = _entry(which, body)(*args)
    if rc == -1:
        raise ValueError(f"the {body} attention body does not take shape "
                         f"{tuple(q.shape)}, {q.dtype}, strides {q.stride()}")
    if rc >= _ENCODE_FAILED:
        raise RuntimeError(
            f"attention {which} kernel ({body}): " + (
                "the driver has no cuTensorMapEncodeTiled"
                if rc == _NO_ENCODER else "the driver refused a tensor map "
                f"(CUresult {rc - _ENCODE_FAILED}) for shape "
                f"{tuple(q.shape)}, strides {q.stride()}"))
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
        wrapper.by_body = dict.fromkeys(BODIES, 0)


reset_launch_counts()


def launch_counts():
    """{(wrapper name, body): launches} of both wrappers."""
    return {(w.__name__, b): n for w in (attention_fwd, attention_bwd)
            for b, n in w.by_body.items()}


def add_launches(counts):
    """Add {(wrapper name, body): n} to the counts: a CUDA graph's replay
    runs the launches its capture recorded without calling the wrappers
    (`core.steps.PlannedStep`)."""
    wrappers = {w.__name__: w for w in (attention_fwd, attention_bwd)}
    for (name, body), n in counts.items():
        wrappers[name].launches += n
        wrappers[name].by_body[body] += n


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
