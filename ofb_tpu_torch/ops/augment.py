"""Batched image augmentation on the device.

Port of ofb_tpu/ops/augment.py: the train transform of the reference
(RandomResizedCrop, horizontal flip, RandAugment 'rand-m9-mstd0.5-inc1' or
color jitter 0.4, normalize, RandomErasing p = 0.25) and the eval
transform, on uint8 NHWC staging batches, as plain batched PyTorch.

As in `ops/mixup.py`, randomness is split from the arithmetic:
`draw_train_augment` draws every per-image parameter (crop box, flip,
RandAugment op / magnitude / sign / enabled per layer or the jitter
factors, the erasing box and its noise) from a generator, and
`apply_train_augment` applies them and draws nothing. Every image carries
its own parameters; ops select per image with `torch.where` on (B, 1, 1, 1)
masks and resample through batched matmuls and gathers, never a Python
loop over images.

Semantics kept from the JAX package, which decide the numbers:

  * the crop resample is `jax.image.scale_and_translate(method="linear")`
    with its default anti-aliasing: a triangle kernel widened by 1 / scale
    when the box is larger than the output, taps outside the image dropped
    and each output row renormalised; applied as Wy @ img @ Wx^T;
  * the eval resize is `jax.image.resize(method="bicubic")`, Keys a = -0.5
    with anti-aliasing (the weights of `models/pos_embed.resize_weights`);
  * `equalize` is the package's 17-knot piecewise-linear CDF from a
    stride-4 subsample, not PIL's;
  * the RandAugment geometry is three shear passes per layer (Paeth
    rotate, shear, translate), each rounding the image to uint8 (half to
    even, fill 128, shift clipped to [-126, 125]) before an integer shift
    and a float32 interpolation of the fractional part; the passes run on
    every layer, with zero coefficients unless the layer's op is
    geometric, after the layer's photometric candidate;
  * RandomErasing replaces its box of the *normalised* image with N(0, 1)
    noise rounded to bfloat16.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.pos_embed import resize_weights
from ..parallel.mesh import draw_rows

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

PHOTO_OPS = ("autocontrast", "equalize", "invert", "posterize", "solarize",
             "solarize_add", "color", "contrast", "brightness", "sharpness")
GEO_OPS = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y")
NUM_OPS = len(PHOTO_OPS) + len(GEO_OPS)
EQ_KNOTS = 16
FILL = 128.0


class AugmentDraws(NamedTuple):
    """The random part of one batch's train transform, B images. Exactly
    one of the RandAugment fields (each (B, L), L layers) and `jitter` is
    set."""
    crop: torch.Tensor                  # (B, 4) y0, x0, h, w, staging pixels
    flip: torch.Tensor                  # (B,) bool
    ra_op: Optional[torch.Tensor]       # (B, L) int64, index into the ops
    ra_mag: Optional[torch.Tensor]      # (B, L) magnitude in [0, 10]
    ra_sign: Optional[torch.Tensor]     # (B, L) +1 or -1
    ra_on: Optional[torch.Tensor]       # (B, L) bool, the layer applies
    jitter: Optional[torch.Tensor]      # (B, 3) brightness, contrast, color
    erase: torch.Tensor                 # (B,) bool
    erase_box: torch.Tensor             # (B, 4) y0, x0, h, w, output pixels
    noise: torch.Tensor                 # (B, out, out, 3), bf16 values


def _uniform(generator, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand((n,), generator=generator,
                                       device=device)


def draw_train_augment(generator, B: int, staging: int, out_size: int, *,
                       use_randaug: bool = True,
                       color_jitter_strength: float = 0.4,
                       re_prob: float = 0.25, crop_scale=(0.08, 1.0),
                       hflip: bool = True, magnitude: float = 9.0,
                       mag_std: float = 0.5, num_layers: int = 2,
                       apply_prob: float = 0.5, device=None) -> AugmentDraws:
    """Draw the train transform's parameters of B images of a square
    staging size from `generator` (on `device`)."""
    dev = device
    H = W = float(staging)
    # RandomResizedCrop box (timm semantics, one clamped draw)
    area = _uniform(generator, B, *crop_scale, dev) * H * W
    log_r = _uniform(generator, B, math.log(3 / 4), math.log(4 / 3), dev)
    r = torch.exp(log_r)
    w = torch.sqrt(area * r).clamp(8.0, W)
    h = torch.sqrt(area / r).clamp(8.0, H)
    y0 = torch.rand((B,), generator=generator, device=dev) * (H - h)
    x0 = torch.rand((B,), generator=generator, device=dev) * (W - w)
    flip = torch.rand((B,), generator=generator, device=dev) < 0.5
    if not hflip:
        flip = torch.zeros_like(flip)
    ra = dict(ra_op=None, ra_mag=None, ra_sign=None, ra_on=None)
    jitter = None
    if use_randaug:
        L = num_layers
        ra["ra_op"] = torch.randint(0, NUM_OPS, (B, L), generator=generator,
                                    device=dev)
        ra["ra_mag"] = (magnitude + mag_std * torch.randn(
            (B, L), generator=generator, device=dev)).clamp(0.0, 10.0)
        ra["ra_sign"] = torch.where(
            torch.rand((B, L), generator=generator, device=dev) < 0.5,
            1.0, -1.0)
        ra["ra_on"] = torch.rand((B, L), generator=generator,
                                 device=dev) < apply_prob
    else:
        s = color_jitter_strength
        jitter = torch.stack([_uniform(generator, B, 1 - s, 1 + s, dev)
                              for _ in range(3)], dim=1)
    # RandomErasing box on the output image
    O = float(out_size)
    erase = torch.rand((B,), generator=generator, device=dev) < re_prob
    a = _uniform(generator, B, 0.02, 1 / 3, dev) * O * O
    r = torch.exp(_uniform(generator, B, math.log(0.3), math.log(3.3), dev))
    eh = torch.sqrt(a * r).clamp(1.0, O)
    ew = torch.sqrt(a / r).clamp(1.0, O)
    ey = torch.rand((B,), generator=generator, device=dev) * (O - eh)
    ex = torch.rand((B,), generator=generator, device=dev) * (O - ew)
    noise = torch.randn((B, out_size, out_size, 3), generator=generator,
                        device=dev).to(torch.bfloat16).float()
    return AugmentDraws(crop=torch.stack([y0, x0, h, w], dim=1), flip=flip,
                        jitter=jitter, erase=erase,
                        erase_box=torch.stack([ey, ex, eh, ew], dim=1),
                        noise=noise, **ra)


# ---------------------------------------------------------------------------
# RandomResizedCrop and the eval resize
# ---------------------------------------------------------------------------

def _linear_weights(n_in: int, n_out: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """(B, n_in, n_out) weights of `jax.image.scale_and_translate`'s
    anti-aliased linear resample of one axis, per image: output o samples
    input (o + 0.5 - t) / s - 0.5 with a triangle kernel widened by
    max(1 / s, 1)."""
    dev = scale.device
    inv = 1.0 / scale
    kscale = torch.clamp_min(inv, 1.0)
    o = torch.arange(n_out, dtype=torch.float32, device=dev)
    sample = (o[None, :] + 0.5) * inv[:, None] \
        - (translation * inv)[:, None] - 0.5                   # (B, n_out)
    i = torch.arange(n_in, dtype=torch.float32, device=dev)
    x = torch.abs(sample[:, None, :] - i[None, :, None]) \
        / kscale[:, None, None]
    w = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None, :], w, 0.0)


def random_resized_crop(images: torch.Tensor, box: torch.Tensor,
                        out_size: int) -> torch.Tensor:
    """images (B, H, W, C) float, box (B, 4) y0, x0, h, w -> (B, out, out,
    C): out[o] = in[y0 + (o + .5) * h / out - .5], anti-aliased linear."""
    B, H, W, C = images.shape
    O = out_size
    y0, x0, h, w = box.unbind(1)
    sy = O / h
    sx = O / w
    wy = _linear_weights(H, O, sy, -y0 * sy)                 # (B, H, out)
    wx = _linear_weights(W, O, sx, -x0 * sx)                 # (B, W, out)
    # two batched matmuls: rows (B, o, W*C), then columns with the channels
    # moved next to the rows so the second is one (o*C, W) @ (W, p) a image
    t = torch.bmm(wy.transpose(1, 2), images.reshape(B, H, W * C))
    t = t.reshape(B, O, W, C).transpose(2, 3).reshape(B, O * C, W)
    t = torch.bmm(t, wx)                                      # (B, o*C, p)
    return t.reshape(B, O, C, O).transpose(2, 3).contiguous()


def center_crop_resize(images: torch.Tensor, out_size: int,
                       crop_pct: float = 0.875) -> torch.Tensor:
    """Eval transform of a float batch (B, H, W, C): bicubic resize of the
    shorter side to out / crop_pct, then the centre out x out crop."""
    B, H, W, C = images.shape
    scale_size = int(out_size / crop_pct)
    short = min(H, W)
    nh = int(round(H * scale_size / short))
    nw = int(round(W * scale_size / short))
    if nh != H:
        wy = torch.from_numpy(resize_weights(H, nh)).to(images.device)
        images = torch.einsum("bhwc,ho->bowc", images, wy)
    if nw != W:
        wx = torch.from_numpy(resize_weights(W, nw)).to(images.device)
        images = torch.einsum("bhwc,wo->bhoc", images, wx)
    y0 = (nh - out_size) // 2
    x0 = (nw - out_size) // 2
    return images[:, y0:y0 + out_size, x0:x0 + out_size]


# ---------------------------------------------------------------------------
# Photometric ops, 0..255 float domain; factors are (B,) tensors
# ---------------------------------------------------------------------------

def _b(t: torch.Tensor) -> torch.Tensor:
    """A per-image (B,) tensor as (B, 1, 1, 1)."""
    return t.reshape(-1, 1, 1, 1)


def _blend(a, b, factor):
    return torch.clamp(b + (a - b) * _b(factor), 0.0, 255.0)


def _grayscale(img):
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def brightness(img, factor):
    # the blend with black: 0 + (img - 0) * f, exactly img * f
    return torch.clamp(img * _b(factor), 0.0, 255.0)


def contrast(img, factor):
    mean = _grayscale(img).mean(dim=(1, 2, 3))
    return _blend(img, _b(mean), factor)


def color(img, factor):
    return _blend(img, _grayscale(img), factor)


def sharpness(img, factor):
    """Blend with the [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 blur (zero
    padded), the 3x3 sum taken as two 3-tap passes."""
    pad = F.pad(img, (0, 0, 1, 1, 1, 1))
    rows = pad[:, :, :-2] + pad[:, :, 1:-1] + pad[:, :, 2:]
    box = rows[:, :-2] + rows[:, 1:-1] + rows[:, 2:]
    return _blend(img, (box + 4.0 * img) / 13.0, factor)


def invert(img):
    return 255.0 - img


def posterize(img, bits):
    """Keep the top `bits` (B,) bits of each uint8 value."""
    p = _b(torch.pow(2.0, 8.0 - bits))
    return torch.floor(torch.trunc(img) / p) * p          # trunc: the uint8


def solarize(img, thresh):
    return torch.where(img >= _b(thresh), 255.0 - img, img)


def solarize_add(img, add):
    return torch.where(img < 128.0, torch.clamp(img + _b(add), 0, 255), img)


def autocontrast(img):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp_min(hi - lo, 1e-5)
    out = (img - lo) * scale
    return torch.where(hi > lo, torch.clamp(out, 0, 255), img)


def equalize(img):
    """Per-channel equalisation as a piecewise-linear CDF through 17
    quantile knots of a stride-4 subsample (the JAX package's form):
    cdf(x) = sum_j clip((x - k_j) / max(k_j+1 - k_j, 1e-5), 0, 1) / 16.
    With the knots sorted, every segment below the one x falls in adds 1
    and every one above 0, so the sum is taken as (segments below) + the
    one fraction, found by a binary search."""
    B, H, W, C = img.shape
    sub = img[:, ::4, ::4, :].reshape(B, -1, C)
    qs = torch.sort(sub, dim=1).values
    S = qs.shape[1]
    ranks = torch.clamp((torch.arange(EQ_KNOTS + 1, device=img.device)
                         * (S - 1)) // EQ_KNOTS, 0, S - 1)
    knots = qs[:, ranks].transpose(1, 2)                   # (B, C, K + 1)
    lo = knots[..., :-1].contiguous()
    hi = knots[..., 1:].contiguous()
    x = img.permute(0, 3, 1, 2).reshape(B, C, H * W).contiguous()
    above = torch.searchsorted(lo, x)                      # knots lo_j < x
    j = (above - 1).clamp_min(0)
    lo_j, hi_j = torch.gather(lo, 2, j), torch.gather(hi, 2, j)
    seg = torch.clamp((x - lo_j) / torch.clamp_min(hi_j - lo_j, 1e-5),
                      0.0, 1.0)
    cdf = torch.where(above > 0, j.float() + seg, 0.0)
    return (cdf / EQ_KNOTS * 255.0).reshape(B, C, H, W).permute(
        0, 2, 3, 1).contiguous()


def _apply_photo_slot(img, op, frac, enh, on):
    """One RandAugment layer's photometric candidate, selected per image by
    op index; images whose op is geometric or whose layer is off pass."""
    cands = (
        lambda: autocontrast(img),
        lambda: equalize(img),
        lambda: invert(img),
        lambda: posterize(img, torch.clamp_min(4 - torch.round(frac * 4),
                                               1)),
        lambda: solarize(img, 256.0 - frac * 256.0),
        lambda: solarize_add(img, frac * 110.0),
        lambda: color(img, enh),
        lambda: contrast(img, enh),
        lambda: brightness(img, enh),
        lambda: sharpness(img, enh),
    )
    out = img
    for i, cand in enumerate(cands):
        out = torch.where(_b((op == i) & on), cand(), out)
    return out


# ---------------------------------------------------------------------------
# Geometric: a composed affine warp (two separable passes), a 2-D bilinear
# sampler, and the shear passes RandAugment runs
# ---------------------------------------------------------------------------

def bilinear_sample(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                    fill: float = FILL) -> torch.Tensor:
    """Sample img (B, H, W, C) bilinearly at float coords sy, sx (B, Ho,
    Wo); taps outside the image are `fill`. As in the JAX package the
    image is first rounded to bfloat16, and the three neighbour taps are
    read at the clipped corner plus one (wrapping), masked by the unclipped
    corner's bounds."""
    B, H, W, C = img.shape
    imgh = img.to(torch.bfloat16).float().reshape(B, H * W, C)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    yf = y0.long()
    xf = x0.long()
    y0i = yf.clamp(0, H - 1)
    x0i = xf.clamp(0, W - 1)

    def tap(dy, dx):
        idx = ((y0i + dy) % H) * W + (x0i + dx) % W
        v = torch.gather(imgh, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        yi, xi = yf + dy, xf + dx
        oob = ((yi < 0) | (yi >= H) | (xi < 0) | (xi >= W))[..., None]
        return torch.where(oob, fill, v.reshape(*sy.shape, C))

    top = tap(0, 0) * (1 - wx) + tap(0, 1) * wx
    bot = tap(1, 0) * (1 - wx) + tap(1, 1) * wx
    return top * (1 - wy) + bot * wy


def _resample_x(img: torch.Tensor, scale: torch.Tensor,
                shift_per_row: torch.Tensor, fill: float) -> torch.Tensor:
    """Per-row 1-D linear resample: out[b, y, x] = in[b, y, scale[b] * x +
    shift[b, y]]."""
    B, H, W, C = img.shape
    x = torch.arange(W, dtype=torch.float32, device=img.device)
    src = scale[:, None, None] * x + shift_per_row[:, :, None]   # (B, H, W)
    k = torch.floor(src)
    f = (src - k)[..., None]
    ki = k.long()

    def take(ix):
        oob = ((ix < 0) | (ix >= W))[..., None]
        g = torch.gather(img, 2, ix.clamp(0, W - 1)[..., None].expand(
            B, H, W, C))
        return torch.where(oob, fill, g)

    return take(ki) * (1.0 - f) + take(ki + 1) * f


def _resample_y(img, scale, shift_per_col, fill):
    return _resample_x(img.transpose(1, 2), scale, shift_per_col,
                       fill).transpose(1, 2)


def affine_warp(img: torch.Tensor, mat: torch.Tensor,
                fill: float = FILL) -> torch.Tensor:
    """Apply per-image 2x3 inverse affine matrices mat (B, 2, 3) (output ->
    source coords about the image centre), bilinear, constant fill, as two
    separable passes: a per-column y resample, then a per-row x resample
    (valid while |m00| > 0; |m00| is held at 0.25 and above)."""
    B, H, W, C = img.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    m00, m01, m02 = mat[:, 0, 0], mat[:, 0, 1], mat[:, 0, 2]
    m10, m11, m12 = mat[:, 1, 0], mat[:, 1, 1], mat[:, 1, 2]
    m00s = torch.where(m00.abs() < 0.25,
                       torch.where(m00 < 0, -0.25, 0.25), m00)
    rho = m10 / m00s
    g = m11 - rho * m01
    tau = m12 - rho * m02
    xs = torch.arange(W, dtype=torch.float32, device=img.device) - cx
    shift_col = rho[:, None] * xs + tau[:, None] + cy - g[:, None] * cy
    out = _resample_y(img, g, shift_col, fill)
    ys = torch.arange(H, dtype=torch.float32, device=img.device) - cy
    shift_row = m01[:, None] * ys + m02[:, None] + cx - m00s[:, None] * cx
    return _resample_x(out, m00s, shift_row, fill)


_SHIFT_PAD = 128


def _shift_frac(img: torch.Tensor, shift: torch.Tensor, dim: int,
                fill: float = FILL) -> torch.Tensor:
    """Shift each row (dim 2, shift (B, H)) or column (dim 1, shift (B, W))
    of img (B, H, W, C) by a fractional amount: out = in[pos + shift],
    the fractional part interpolated linearly. The image is first rounded
    to uint8 values (half to even); samples outside are `fill`; the shift
    is clipped to [-126, 125]."""
    B, H, W, C = img.shape
    n = img.shape[dim]
    shift = torch.clamp(shift, -126.0, 125.0)
    k = torch.floor(shift)
    f = shift - k
    # the rounded image between `fill` margins of _SHIFT_PAD, so every
    # shifted index lands inside and a sample past the edge reads the fill
    u = F.pad(torch.clamp(torch.round(img), 0, 255),
              (0, 0, _SHIFT_PAD, _SHIFT_PAD) if dim == 2 else
              (0, 0, 0, 0, _SHIFT_PAD, _SHIFT_PAD), value=float(round(fill)))
    pos = torch.arange(n, device=img.device) + _SHIFT_PAD
    if dim == 2:
        idx = pos[None, None, :] + k.long()[:, :, None]          # (B, H, W)
        f = f[:, :, None, None]
    else:
        idx = pos[None, :, None] + k.long()[:, None, :]
        f = f[:, None, :, None]

    def take(ix):
        return torch.gather(u, dim, ix[..., None].expand(B, H, W, C))

    return take(idx) * (1.0 - f) + take(idx + 1) * f


def _row_shift_frac(img: torch.Tensor, shift: torch.Tensor,
                    fill: float = FILL) -> torch.Tensor:
    """out[b, y, x] = in[b, y, x + shift[b, y]]; see `_shift_frac`."""
    return _shift_frac(img, shift, 2, fill)


def _col_shift_frac(img: torch.Tensor, shift: torch.Tensor,
                    fill: float = FILL) -> torch.Tensor:
    """out[b, y, x] = in[b, y + shift[b, x], x]; see `_shift_frac`."""
    return _shift_frac(img, shift, 1, fill)


def _geo_slot(img, op, frac, sign, on):
    """One RandAugment layer's geometry: rotate (Paeth: shear x, shear y,
    shear x), shear and translate as three shear passes whose coefficients
    are zero unless the layer's op is that geometric op."""
    B, H, W, _ = img.shape
    geo = op - len(PHOTO_OPS)
    on = on.float()
    th = sign * frac * (30.0 * math.pi / 180.0)
    shear = sign * frac * 0.3
    trans = sign * frac * 0.45
    is_rot = on * (geo == 0)
    sx1 = is_rot * -torch.tan(th / 2.0) + on * (geo == 1) * shear
    sy_s = is_rot * torch.sin(th) + on * (geo == 2) * shear
    sx2 = is_rot * -torch.tan(th / 2.0)
    tx = on * (geo == 3) * trans * W
    ty = on * (geo == 4) * trans * H
    ys = torch.arange(H, dtype=torch.float32, device=img.device) \
        - (H - 1) / 2.0
    xs = torch.arange(W, dtype=torch.float32, device=img.device) \
        - (W - 1) / 2.0
    img = _row_shift_frac(img, sx1[:, None] * ys + tx[:, None])
    img = _col_shift_frac(img, sy_s[:, None] * xs + ty[:, None])
    return _row_shift_frac(img, sx2[:, None] * ys)


def rand_augment(img, op, mag, sign, on):
    """timm RandAugment with per-image (B, L) layer parameters: each layer
    its photometric candidate, then its three shear passes."""
    for layer in range(op.shape[1]):
        frac = mag[:, layer] / 10.0
        enh = 1.0 + sign[:, layer] * frac * 0.9
        img = _apply_photo_slot(img, op[:, layer], frac, enh, on[:, layer])
        img = _geo_slot(img, op[:, layer], frac, sign[:, layer],
                        on[:, layer])
    return img


# ---------------------------------------------------------------------------
# Color jitter, RandomErasing, normalize
# ---------------------------------------------------------------------------

def color_jitter(img, factors):
    """factors (B, 3): brightness, contrast, saturation, in that order."""
    img = brightness(img, factors[:, 0])
    img = contrast(img, factors[:, 1])
    return color(img, factors[:, 2])


def random_erasing(img_norm, erase, box, noise):
    """Replace each erased image's box of the normalised image with its
    noise."""
    B, H, W, _ = img_norm.shape
    y0, x0, h, w = (t[:, None, None] for t in box.unbind(1))
    rows = torch.arange(H, dtype=torch.float32,
                        device=img_norm.device)[None, :, None]
    cols = torch.arange(W, dtype=torch.float32,
                        device=img_norm.device)[None, None, :]
    inside = (rows >= y0) & (rows < y0 + h) & (cols >= x0) & (cols < x0 + w)
    return torch.where((inside & erase[:, None, None])[..., None],
                       noise.to(img_norm.dtype), img_norm)


@functools.lru_cache(maxsize=8)
def _mean_std(device: torch.device):
    """ImageNet mean and std on `device`, copied there once (a copy from
    the host cannot run inside a CUDA graph's capture)."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize(img255: torch.Tensor) -> torch.Tensor:
    mean, std = _mean_std(img255.device)
    return (img255 / 255.0 - mean) / std


# ---------------------------------------------------------------------------
# Whole transforms
# ---------------------------------------------------------------------------

def apply_train_augment(images_u8: torch.Tensor, draws: AugmentDraws, *,
                        out_size: int = 224) -> torch.Tensor:
    """uint8 staging batch (B, S, S, 3) -> augmented, normalised float32
    (B, out, out, 3) with the given draws. Deterministic."""
    img = random_resized_crop(images_u8.float(), draws.crop, out_size)
    img = torch.where(_b(draws.flip), img.flip(2), img)
    if draws.ra_op is not None:
        img = rand_augment(img, draws.ra_op, draws.ra_mag, draws.ra_sign,
                           draws.ra_on)
    else:
        img = color_jitter(img, draws.jitter)
    img = normalize(img)
    return random_erasing(img, draws.erase, draws.erase_box, draws.noise)


def train_augment_batch(generator, images_u8: torch.Tensor, *,
                        out_size: int = 224, use_randaug: bool = True,
                        color_jitter_strength: float = 0.4,
                        re_prob: float = 0.25, crop_scale=(0.08, 1.0),
                        hflip: bool = True) -> torch.Tensor:
    """The train transform with parameters drawn from `generator` (this
    rank's rows of the global batch's draws under data parallelism)."""
    draws = draw_rows(lambda n: draw_train_augment(
        generator, n, images_u8.shape[1], out_size,
        use_randaug=use_randaug, color_jitter_strength=color_jitter_strength,
        re_prob=re_prob, crop_scale=crop_scale, hflip=hflip,
        device=images_u8.device), images_u8.shape[0])
    return apply_train_augment(images_u8, draws, out_size=out_size)


def eval_preprocess_batch(images_u8: torch.Tensor, out_size: int = 224
                          ) -> torch.Tensor:
    """Eval transform of a uint8 staging batch: resize + centre crop to
    out_size unless already there, then normalize. Deterministic."""
    img = images_u8.float()
    if tuple(img.shape[1:3]) != (out_size, out_size):
        img = center_crop_resize(img, out_size)
    return normalize(img)

