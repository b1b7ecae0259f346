"""Device-side Mixup / CutMix with label smoothing.

Port of ofb_tpu/ops/mixup.py, split in two so that randomness never has to
cross frameworks: `mixup_draws` draws the parameters of a batch (one mixing
weight and one box per draw), `apply_mixup` mixes images and labels with
them and draws nothing. `mixup_cutmix` is the two in a row. Modes:

  mode='batch'  one lambda / box per batch
  mode='pair'   one per (i, B-1-i) pair, applied to both of its elements
  mode='elem'   one per element
  cutmix_minmax ratio-bounded box fully inside the image; overrides the
                sqrt(1 - lam) box

Boxes are row / column comparisons against per-draw corners, (n, H, W)
masks; every mode is a fixed-shape computation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class MixupDraws(NamedTuple):
    """The random part of one batch's mixup: n = 1 (batch), B // 2 (pair)
    or B (elem) draws."""
    lam: torch.Tensor            # (n,) weight of the element itself
    box: torch.Tensor            # (n, H, W) 1 inside the CutMix box


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.0) -> torch.Tensor:
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


def _box_mask(H: int, W: int, y1, y2, x1, x2) -> torch.Tensor:
    """(n, H, W) masks with 1 inside [y1, y2) x [x1, x2) per draw."""
    rows = torch.arange(H, device=y1.device)[None, :, None]
    cols = torch.arange(W, device=y1.device)[None, None, :]
    y1, y2 = y1[:, None, None], y2[:, None, None]
    x1, x2 = x1[:, None, None], x2[:, None, None]
    return ((rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)).float()


def _rand_bbox(generator, H: int, W: int, lam: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """timm rand_bbox: centre anywhere, side ratio sqrt(1 - lam), clipped
    at the borders. lam (n,) -> masks (n, H, W), corrected lam (n,)."""
    cut_rat = torch.sqrt(1.0 - lam)
    cut_h = (H * cut_rat).to(torch.int32)
    cut_w = (W * cut_rat).to(torch.int32)
    n = lam.shape[0]
    cy = torch.randint(0, H, (n,), generator=generator, device=lam.device)
    cx = torch.randint(0, W, (n,), generator=generator, device=lam.device)
    y1 = (cy - cut_h // 2).clamp(0, H)
    y2 = (cy + cut_h // 2).clamp(0, H)
    x1 = (cx - cut_w // 2).clamp(0, W)
    x2 = (cx + cut_w // 2).clamp(0, W)
    box = _box_mask(H, W, y1, y2, x1, x2)
    lam_adj = 1.0 - ((y2 - y1) * (x2 - x1)) / (H * W)
    return box, lam_adj


def _rand_bbox_minmax(generator, H: int, W: int, n: int,
                      minmax: Tuple[float, float], device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """timm rand_bbox_minmax: per-side ratio uniform in [min, max), box
    fully inside the image; lam comes entirely from the box area."""
    lo_h, lo_w = int(H * minmax[0]), int(W * minmax[0])
    cut_h = torch.randint(lo_h, max(int(H * minmax[1]), lo_h + 1), (n,),
                          generator=generator, device=device)
    cut_w = torch.randint(lo_w, max(int(W * minmax[1]), lo_w + 1), (n,),
                          generator=generator, device=device)
    uy = torch.rand((n,), generator=generator, device=device)
    ux = torch.rand((n,), generator=generator, device=device)
    y1 = (uy * (H - cut_h)).to(torch.int32)
    x1 = (ux * (W - cut_w)).to(torch.int32)
    box = _box_mask(H, W, y1, y1 + cut_h, x1, x1 + cut_w)
    lam = 1.0 - (cut_h * cut_w) / (H * W)
    return box, lam.float()


def _beta(generator, alpha: float, n: int, device) -> torch.Tensor:
    """n draws of Beta(alpha, alpha), as two gamma draws."""
    conc = torch.full((2, n), float(alpha), device=device)
    g = torch._standard_gamma(conc, generator=generator)
    return g[0] / (g[0] + g[1])


def mixup_draws(generator, B: int, H: int, W: int, *,
                mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                cutmix_minmax: Optional[Tuple[float, float]] = None,
                prob: float = 1.0, switch_prob: float = 0.5,
                mode: str = "batch", device=None) -> Optional[MixupDraws]:
    """Draw one batch's mixing weights and boxes from `generator`; None
    when both Mixup and CutMix are off."""
    if mode not in ("batch", "pair", "elem"):
        raise ValueError(f"mixup mode '{mode}' (batch | pair | elem)")
    use_mix = mixup_alpha > 0.0
    use_cut = cutmix_alpha > 0.0 or cutmix_minmax is not None
    if not use_mix and not use_cut:
        return None
    n = {"batch": 1, "pair": B // 2, "elem": B}[mode]

    def rand():
        return torch.rand((n,), generator=generator, device=device)

    apply = rand() < prob
    if use_mix and use_cut:
        do_cut = rand() < switch_prob
    else:
        do_cut = torch.full((n,), use_cut, device=device)
    lam_m = _beta(generator, mixup_alpha, n, device) if use_mix \
        else torch.ones((n,), device=device)
    if cutmix_minmax is not None:
        box, lam_c_adj = _rand_bbox_minmax(generator, H, W, n, cutmix_minmax,
                                           device)
    else:
        lam_c = _beta(generator, cutmix_alpha, n, device) if use_cut \
            else torch.ones((n,), device=device)
        box, lam_c_adj = _rand_bbox(generator, H, W, lam_c)

    lam = torch.where(do_cut, lam_c_adj, lam_m)
    box = box * do_cut[:, None, None]               # no box in mixup draws
    lam = torch.where(apply, lam, 1.0)
    box = box * apply[:, None, None]
    return MixupDraws(lam=lam, box=box)


def apply_mixup(images: torch.Tensor, labels: torch.Tensor,
                draws: Optional[MixupDraws], *, num_classes: int,
                mode: str = "batch", label_smoothing: float = 0.1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix images (B, H, W, C) and labels int (B,) with the given draws;
    each element's partner is its mirror B-1-i. Returns (mixed images,
    soft labels (B, num_classes)). Deterministic."""
    if mode not in ("batch", "pair", "elem"):
        raise ValueError(f"mixup mode '{mode}' (batch | pair | elem)")
    B, H, W, _ = images.shape
    y = one_hot_smooth(labels, num_classes, label_smoothing)
    if draws is None:
        return images, y
    lam, box = (t.to(images.device, torch.float32) for t in draws)

    # expand draws to per-element vectors of length B
    if mode == "batch":
        lam_e = lam.expand(B)
        box_e = box.expand(B, H, W)
    elif mode == "pair":
        # pair (i, B-1-i) shares its draw; an odd middle element is untouched
        n = lam.shape[0]
        lam_e = torch.cat([lam, lam.new_ones(B - 2 * n), lam.flip(0)])
        box_e = torch.cat([box, box.new_zeros((B - 2 * n, H, W)),
                           box.flip(0)])
    else:
        lam_e, box_e = lam, box

    flip_im = images.flip(0)
    flip_y = y.flip(0)
    lam_im = lam_e[:, None, None, None].to(images.dtype)
    box_im = box_e[:, :, :, None].to(images.dtype)
    # cutmix where a box is set, mixup elsewhere (the box is all 0 in mixup
    # draws, so the two compose into one expression)
    mixed = lam_im * images + (1.0 - lam_im) * flip_im
    is_cut = (box_e.amax(dim=(1, 2)) > 0)[:, None, None, None]
    base = torch.where(is_cut, images, mixed)
    out_im = base * (1.0 - box_im) + flip_im * box_im
    out_y = lam_e[:, None] * y + (1.0 - lam_e[:, None]) * flip_y
    return out_im.to(images.dtype), out_y


def mixup_cutmix(generator, images: torch.Tensor, labels: torch.Tensor, *,
                 num_classes: int, mixup_alpha: float = 0.8,
                 cutmix_alpha: float = 1.0,
                 cutmix_minmax: Optional[Tuple[float, float]] = None,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 mode: str = "batch", label_smoothing: float = 0.1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixup / CutMix with parameters drawn from `generator`."""
    B, H, W, _ = images.shape
    draws = mixup_draws(generator, B, H, W, mixup_alpha=mixup_alpha,
                        cutmix_alpha=cutmix_alpha,
                        cutmix_minmax=cutmix_minmax, prob=prob,
                        switch_prob=switch_prob, mode=mode,
                        device=images.device)
    return apply_mixup(images, labels, draws, num_classes=num_classes,
                       mode=mode, label_smoothing=label_smoothing)
