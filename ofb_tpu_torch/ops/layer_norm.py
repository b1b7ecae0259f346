"""Layer norm over the last dim, masked or plain: a hand-written CUDA kernel
pair and its plain PyTorch twins.

No TPU kernel is replaced. The JAX package writes both norms as plain jnp
ops (ofb_tpu/ops/gates.py `masked_layer_norm`, `layer_norm`) and XLA fuses
the chain on the TPU. In eager PyTorch the same chain is ten to fourteen
fp32 passes over the (B, N, D) activations, forward, and autograd's
backward through it several more, with three fp32 copies of the
activations saved between the two. The kernels (csrc/layer_norm.cu) read x
once and write y once in the forward, and read x and dy once and write dx
once in the backward: they are bound by those bytes, and their design
(a row a group of 8, 16 or 32 lanes, held in registers as chunks of 8 or
16 bytes a lane, the warp's next rows already on their way into shared
memory by cp.async, gamma and beta in shared memory and the live mask in
registers across the rows a warp walks, dgamma and dbeta summed in
registers and then over blocks in a fixed order by a second kernel, no
atomics) moves nothing else. Only the per-row mean and rstd (fp32) are
saved for the backward.

The functions the models call are `ops.gates.masked_layer_norm` and
`ops.gates.layer_norm`: on a CPU tensor they run the eager twins
`masked_layer_norm_reference` / `layer_norm_reference` here (the chain the
kernels replace, unchanged), on a CUDA tensor `fused_layer_norm`, whose
autograd Function calls the wrappers `layer_norm_fwd` / `layer_norm_bwd`.
The wrappers launch the kernels on a CUDA tensor (or raise) and run the
plain versions `layer_norm_fwd_reference` / `layer_norm_bwd_reference`
(the kernels' arithmetic, the backward in closed form) on a CPU one; each
counts its launches in `.launches` and, by kind ('masked', 'plain'), in
`.by_kind`.

The arithmetic, in fp32 whatever the input's type: with live = mask > 0
(every channel without a mask) and cnt = max(#live, 1), mean and the
biased variance over the live channels, x̂ = (x - mean) rstd,
rstd = 1 / sqrt(var + eps); y = x̂ gamma + beta on live channels, and on
dropped ones 0 ('zero') or x ('identity'). Backward, with g = dy gamma:
dx = rstd (g - mean(g) - x̂ mean(g x̂)) on live channels (means over them),
dy ('identity') or 0 ('zero') on dropped ones; dgamma = Σ dy x̂ and
dbeta = Σ dy over rows on live channels, 0 on dropped ones. The mask gets
no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPES = (torch.float32, torch.bfloat16)
PASSTHROUGH = ("zero", "identity")
# the kernels' modes: 0 the plain norm, then PASSTHROUGH's
_MODES = {None: 0, "zero": 1, "identity": 2}
# rows path: a lane holds NV chunks of VEC elements, NV one of these, and
# at most 32 elements; wider rows take the looped kernels (nv 0)
_TIERS = (1, 2, 3, 4, 6, 8)
_MAX_LANE = 32
# lanes a row takes, with 16-byte chunks (else always 32)
_GROUPS = (8, 16, 32)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def masked_layer_norm_reference(x, mask, scale, bias, *, eps: float = 1e-6,
                                passthrough: str = "zero") -> torch.Tensor:
    """LayerNorm over the masked-in channels, in place (channel order kept),
    with masked moments.

    passthrough: 'zero' — dropped channels output 0 (patch-embed output,
    final norm); 'identity' — dropped channels pass through (block norms).
    """
    if passthrough not in ("zero", "identity"):
        raise ValueError(passthrough)
    xf = x.float()
    m = (mask > 0).float()
    cnt = m.sum().clamp_min(1.0)
    mean = (xf * m).sum(dim=-1, keepdim=True) / cnt
    var = ((xf - mean).square() * m).sum(dim=-1, keepdim=True) / cnt
    normed = (xf - mean) * torch.rsqrt(var + eps)
    normed = normed * scale.float() + bias.float()
    if passthrough == "zero":
        out = normed * m
    else:
        out = torch.where(m > 0, normed, xf)
    return out.to(x.dtype)


def layer_norm_reference(x, scale, bias, *, eps: float = 1e-6) -> torch.Tensor:
    """Plain LayerNorm (biased variance) computed in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _live(mask, D: int, device):
    """(live channels as 0/1 fp32 (D,), cnt = max(#live, 1))."""
    m = torch.ones(D, device=device) if mask is None else (mask > 0).float()
    return m, m.sum().clamp_min(1.0)


def layer_norm_fwd_reference(x, mask, scale, bias, eps: float,
                             passthrough=None):
    """Plain version of the forward kernel over rows x (R, D): (y in x's
    type, mean (R,), rstd (R,) fp32)."""
    xf = x.float()
    m, cnt = _live(mask, x.shape[-1], x.device)
    mean = (xf * m).sum(dim=-1) / cnt
    xc = xf - mean[:, None]
    rstd = 1.0 / torch.sqrt((xc.square() * m).sum(dim=-1) / cnt + eps)
    y = xc * rstd[:, None] * scale.float() + bias.float()
    y = torch.where(m > 0, y, xf if passthrough == "identity" else 0.0)
    return y.to(x.dtype), mean, rstd


def layer_norm_bwd_reference(x, dy, mask, scale, mean, rstd,
                             passthrough=None):
    """Plain version of the backward kernels: (dx in x's type, dgamma,
    dbeta fp32 (D,)) from rows x, dy (R, D) and the forward's mean, rstd."""
    xf, dyf = x.float(), dy.float()
    m, cnt = _live(mask, x.shape[-1], x.device)
    xhat = (xf - mean[:, None]) * rstd[:, None]
    g = dyf * scale.float()
    a = (g * m).sum(dim=-1, keepdim=True) / cnt
    c = (g * xhat * m).sum(dim=-1, keepdim=True) / cnt
    dx = rstd[:, None] * (g - a - xhat * c)
    dx = torch.where(m > 0, dx, dyf if passthrough == "identity" else 0.0)
    return dx.to(x.dtype), (dyf * xhat * m).sum(dim=0), (dyf * m).sum(dim=0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def vector_width(D: int, itemsize: int, *rows) -> int:
    """Elements a lane reads or writes at once: the widest of 16, 8, 4, 2
    or 1 bytes that D, every row stride and every pointer of `rows` ((data
    pointer, row stride in elements) pairs) are multiples of."""
    vec = 16 // itemsize
    while vec > 1 and (D % vec or any(
            p % (vec * itemsize) or s % vec for p, s in rows)):
        vec //= 2
    return vec


def lane_tier(D: int, vec: int, lanes: int = 32) -> int:
    """NV, the chunks a lane holds on the rows path (the smallest of
    _TIERS that covers a row of D with `lanes` lanes), or 0 for the looped
    kernels (more than _MAX_LANE elements a lane)."""
    need = -(-D // (lanes * vec))
    for nv in _TIERS:
        if nv >= need:
            return nv if nv * vec <= _MAX_LANE else 0
    return 0


def row_layout(D: int, itemsize: int, *rows):
    """(lanes, vec, nv) of a call: a group of `lanes` lanes takes a row,
    each lane nv chunks of vec elements, vec `vector_width`'s. With chunks
    of 16 bytes a group is 8, 16 or 32 lanes, else 32: the one that covers
    a row of D with the fewest idle columns (lanes vec nv - D), the smaller
    on a tie (a lane's fixed work a row is then shared by more columns).
    nv 0 (the looped kernels) where the chunks are under 8 bytes or no
    row fits in registers."""
    vec = vector_width(D, itemsize, *rows)
    best = (32, vec, 0)
    if vec * itemsize < 8:
        return best
    for lanes in (_GROUPS if vec * itemsize == 16 else (32,)):
        nv = lane_tier(D, vec, lanes)
        if nv and (not best[2] or lanes * nv < best[0] * best[2]):
            best = (lanes, vec, nv)
    return best


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import load
    lib = load("layer_norm")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.ofb_layer_norm_grid.argtypes = [i] * 7
    lib.ofb_layer_norm_fwd.argtypes = [p, ll] + [p] * 6 + [i, i, f] \
        + [i] * 6 + [p]
    lib.ofb_layer_norm_bwd.argtypes = [p, ll, p, ll] + [p] * 7 + [i] * 9 \
        + [p]
    for fn in (lib.ofb_layer_norm_grid, lib.ofb_layer_norm_fwd,
               lib.ofb_layer_norm_bwd):
        fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _grid(which: int, device: int, bf16: int, lanes: int, vec: int, nv: int,
          rows: int, D: int) -> int:
    """The C side's grid (0: forward, 1: backward) or partial rows (2) for
    the call; a host query, made once a shape (before any capture)."""
    n = _lib().ofb_layer_norm_grid(which, bf16, lanes, vec, nv, rows, D)
    if n < 1:
        raise RuntimeError(f"layer norm: no grid for rows {rows}, D {D}, "
                           f"lanes {lanes}, vec {vec}, nv {nv} (code {n})")
    return n


def _rows(t: torch.Tensor, D: int) -> torch.Tensor:
    """t as (rows, D) with contiguous rows (a view where one exists)."""
    t2 = t.reshape(-1, D)
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _layout(D: int, *ts):
    """(lanes, vec, nv) of a call over the (rows, D) tensors ts."""
    return row_layout(D, ts[0].element_size(),
                      *((t.data_ptr(), t.stride(0)) for t in ts))


def _check(x, mask, scale, bias, passthrough):
    if x.device.type != "cuda":
        raise RuntimeError(f"no layer-norm kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the layer-norm kernels take float32 or bfloat16, "
                        f"not {x.dtype}")
    D = x.shape[-1]
    for name, t in (("mask", mask), ("scale", scale), ("bias", bias)):
        if t is not None and (t.numel() != D or t.device != x.device):
            raise ValueError(f"layer norm: {name} of shape {tuple(t.shape)} "
                             f"on {t.device} for rows of {D} on {x.device}")
    if (mask is None) != (passthrough is None):
        raise ValueError("layer norm: a mask needs a passthrough and a "
                         "passthrough a mask")
    return D


def _vector(t):
    return None if t is None else t.reshape(-1).float().contiguous()


def _count(wrapper, mask):
    wrapper.launches += 1
    wrapper.by_kind["plain" if mask is None else "masked"] += 1


def layer_norm_fwd(x, mask, scale, bias, eps: float, passthrough=None):
    """(y, mean, rstd) of the norm over rows x (R, D) with contiguous rows;
    mask None for the plain norm, else (D,) with `passthrough` 'zero' or
    'identity'. CUDA tensors: the forward kernel; CPU tensors: the twin."""
    if x.device.type == "cpu":
        return layer_norm_fwd_reference(x, mask, scale, bias, eps,
                                        passthrough)
    D = _check(x, mask, scale, bias, passthrough)
    rows = x.shape[0]
    y = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if rows == 0:
        return y, mean, rstd
    m, g, b = _vector(mask), _vector(scale), _vector(bias)
    bf16, lay = int(x.dtype == torch.bfloat16), _layout(D, x)
    grid = _grid(0, x.device.index or 0, bf16, *lay, rows, D)
    rc = _lib().ofb_layer_norm_fwd(
        x.data_ptr(), x.stride(0), None if m is None else m.data_ptr(),
        g.data_ptr(), b.data_ptr(), y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), rows, D, float(eps), _MODES[passthrough], bf16,
        *lay, grid, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer-norm forward kernel failed: code {rc} "
                           f"(rows {rows}, D {D}, lanes, vec, nv {lay})")
    _count(layer_norm_fwd, mask)
    return y, mean, rstd


def layer_norm_bwd(x, dy, mask, scale, mean, rstd, passthrough=None):
    """(dx, dgamma, dbeta) of the norm over rows x (R, D), from dy (R, D)
    and the forward's mean and rstd; dgamma and dbeta fp32 (D,). One call
    is one launch in the count (two or three kernels on the card). CUDA
    tensors: the backward kernels; CPU tensors: the twin."""
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, dy, mask, scale, mean, rstd,
                                        passthrough)
    D = _check(x, mask, scale, None, passthrough)
    rows = x.shape[0]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("layer norm: dy must match x in shape, type and "
                         "device")
    dx = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    if rows == 0:
        zero = torch.zeros(D, dtype=torch.float32, device=x.device)
        return dx, zero, zero.clone()
    m, g = _vector(mask), _vector(scale)
    bf16, lay = int(x.dtype == torch.bfloat16), _layout(D, x, dy)
    key = (x.device.index or 0, bf16, *lay, rows, D)
    grid, parts = _grid(1, *key), _grid(2, *key)
    partial = torch.empty((parts, 2 * D), dtype=torch.float32,
                          device=x.device)
    dgb = torch.empty(2 * D, dtype=torch.float32, device=x.device)
    rc = _lib().ofb_layer_norm_bwd(
        x.data_ptr(), x.stride(0), dy.data_ptr(), dy.stride(0),
        None if m is None else m.data_ptr(), g.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), partial.data_ptr(), dgb.data_ptr(),
        rows, D, _MODES[passthrough], bf16, *lay, grid, parts,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer-norm backward kernels failed: code {rc} "
                           f"(rows {rows}, D {D}, lanes, vec, nv {lay})")
    _count(layer_norm_bwd, mask)
    return dx, dgb[:D], dgb[D:]


def reset_launch_counts():
    for wrapper in (layer_norm_fwd, layer_norm_bwd):
        wrapper.launches = 0
        wrapper.by_kind = {"masked": 0, "plain": 0}


reset_launch_counts()


def launch_counts():
    """{(wrapper name, kind): launches} of both wrappers."""
    return {(w.__name__, k): n for w in (layer_norm_fwd, layer_norm_bwd)
            for k, n in w.by_kind.items()}


def add_launches(counts):
    """Add {(wrapper name, kind): n} to the counts (a CUDA graph's replay,
    `core.steps.PlannedStep`)."""
    wrappers = {w.__name__: w for w in (layer_norm_fwd, layer_norm_bwd)}
    for (name, kind), n in counts.items():
        wrappers[name].launches += n
        wrappers[name].by_kind[kind] += n


class _FusedLayerNorm(torch.autograd.Function):
    """The norm's custom gradient: saves x, the mask, gamma and the
    forward's per-row mean and rstd; dgamma and dbeta are handed back in
    the types of gamma and beta."""

    @staticmethod
    def forward(ctx, x, mask, scale, bias, eps, passthrough):
        x2 = _rows(x, x.shape[-1])
        y, mean, rstd = layer_norm_fwd(x2, mask, scale, bias, eps,
                                       passthrough)
        ctx.save_for_backward(x2, mask, scale, mean, rstd)
        ctx.passthrough, ctx.bias_dtype = passthrough, bias.dtype
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, mask, scale, mean, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x2, _rows(dy, x2.shape[-1]), mask, scale,
                                    mean, rstd, ctx.passthrough)
        return (dx.view(dy.shape), None, dg.to(scale.dtype).view(scale.shape),
                db.to(ctx.bias_dtype).view(scale.shape), None, None)


def fused_layer_norm(x, scale, bias, *, mask=None, eps: float = 1e-6,
                     passthrough=None) -> torch.Tensor:
    """The norm over x's last dim through the kernel pair (the plain twins
    on a CPU tensor): plain without a mask, else masked with `passthrough`
    'zero' or 'identity'."""
    if mask is not None and passthrough not in PASSTHROUGH:
        raise ValueError(passthrough)
    if mask is None:
        passthrough = None
    return _FusedLayerNorm.apply(x, mask, scale, bias, eps, passthrough)
