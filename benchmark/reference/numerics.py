"""Where the reference multiplies matrices, and in which precision.

Every matrix product of the reference goes through `linear`, `conv2d` or
`attention` here. A plain run computes them in fp32, with TF32 off
(`fp32_only`). Inside `fp8()` (the control that the comparison must fail)
each product's operands are rounded to float8 first, as an fp8 GEMM takes
them: the forward's to e4m3, the gradient that reaches the product in the
backward to e5m2, each tensor scaled by its own largest magnitude; the
products still accumulate in fp32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_FP8 = [False]
_FMAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


@contextlib.contextmanager
def fp32_only():
    """TF32 off for matmuls and convolutions, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def fp8():
    """Round every matrix product's operands to float8 inside the block."""
    _FP8.append(True)
    try:
        yield
    finally:
        _FP8.pop()


def _round(x: torch.Tensor, fmt) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / _FMAX[fmt]
    return ((x / scale).to(fmt).to(x.dtype) * scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    """Forward: the operand rounded to e4m3; the gradient passes."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Product(torch.autograd.Function):
    """Forward: the product unchanged; backward: its gradient rounded to
    e5m2 before the products of the backward use it."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _in(x):
    return _Operand.apply(x) if _FP8[-1] else x


def _out(y):
    return _Product.apply(y) if _FP8[-1] else y


def linear(x, w, b=None):
    return _out(F.linear(_in(x), _in(w), b))


def conv2d(x, w, b, stride):
    return _out(F.conv2d(_in(x), _in(w), b, stride=stride))


def attention(q, k, v, scale):
    """Softmax attention over (B, N, H, d), the scores and the
    probabilities materialised, softmax in fp32."""
    s = _out(torch.einsum("bnhd,bmhd->bhnm", _in(q * scale), _in(k)))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return _out(torch.einsum("bhnm,bmhd->bnhd", _in(p), _in(v)))
