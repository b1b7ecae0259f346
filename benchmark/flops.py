"""The work a cell's step computes, from shapes: the benchmark's own, frozen
arithmetic, for `mfu` and the attention roofline.

The configuration's `arch` chooses the count: "vit" (or no `arch`), a ViT
whose every block attends globally over its patches and the class token;
"swin", a Swin (`img_size`, `patch_size`, `in_chans`, `num_classes`,
`embed_dim`, `depths`, `num_heads`, `window`, `mlp_ratio`) whose stage s has
width C = embed_dim·2^s over an r × r grid, r = img_size / patch_size / 2^s,
attends within w × w windows (w = `window`, never clipped to the stage, as
the port runs it: a side off a multiple of w raises) and is merged 2 × 2
into the next stage. Any other `arch` raises.

FLOPs count 2 a multiply-add. A training step's backward is twice its
forward, except the patch embedding's, which has no input to differentiate
(the images) and takes its weight gradient only. Nothing recomputed is
counted. Width is counted as computed: the gated supernet at its full width
(the gates mask channels, they do not remove them) with the PMIM decoder and
its locally normalised targets (two banded matmuls an axis, for the pixels
and their squares, forward only); a subnet at its own widths. Elementwise
work (norms, activations, softmax, the augment) is not counted.

The attention bounds: per call of (B, N, H, d) in bf16, the forward reads
q, k, v and writes o (8 bytes an element of one of them) in 4 B H N² d
FLOPs; the backward reads q, k, v, o and do (o for delta = rowsum(do ⊙ o))
and writes dq, dk and dv (16 bytes an element) in 10 B H N² d FLOPs. The
fp32 rows of lse and delta, d times smaller, are left out. The bound is the
larger of operations over the peak and bytes over the memory's rate.
Unpadded shapes, each byte read once. (`chip_smoke.py`'s kernel phase counts
the backward's bytes without o: 14 an element.)
"""

from __future__ import annotations

from typing import List, Tuple

from .peaks import H100

Call = Tuple[int, int, int, int]         # (B, N, H, d) of one attention


def _dims(cfg: dict, i: int) -> Tuple[int, int, int]:
    over = cfg.get("block_overrides")
    if over:
        return tuple(over[i])
    H = cfg["num_heads"]
    d = cfg.get("head_dim") or cfg["embed_dim"] // H
    hidden = cfg.get("mlp_hidden") or int(cfg["embed_dim"] * cfg["mlp_ratio"])
    return H, d, hidden


def arch(cfg: dict) -> str:
    """The configuration's architecture: "vit" or "swin"."""
    a = cfg.get("arch", "vit")
    if a not in ("vit", "swin"):
        raise ValueError(f"no FLOP count for the architecture {a!r}")
    return a


def tokens(cfg: dict) -> int:
    return (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1


def forward_macs(cfg: dict) -> dict:
    """Multiply-adds of one image's forward, by part: patch embedding,
    each block's projections and attention products, (a Swin's) the patch
    merging between stages, the head."""
    if arch(cfg) == "swin":
        return _swin_forward_macs(cfg)
    D, p = cfg["embed_dim"], cfg["patch_size"]
    C = cfg.get("in_chans", 3)
    L = (cfg["img_size"] // p) ** 2
    N = L + 1
    out = {"patch": L * D * p * p * C, "blocks": 0,
           "head": D * cfg["num_classes"]}
    for i in range(cfg["depth"]):
        H, d, hidden = _dims(cfg, i)
        out["blocks"] += (N * D * 3 * H * d          # qkv
                          + 2 * H * N * N * d         # q kᵀ, p v
                          + N * H * d * D             # proj
                          + 2 * N * D * hidden)       # fc1, fc2
    return out


def _swin_forward_macs(cfg: dict) -> dict:
    p, w = cfg["patch_size"], cfg["window"]
    side = cfg["img_size"] // p
    C = cfg["embed_dim"]
    out = {"patch": side * side * C * p * p * cfg.get("in_chans", 3),
           "blocks": 0, "merge": 0}
    for s, depth in enumerate(cfg["depths"]):
        if side % w:
            raise ValueError(f"stage {s}'s side {side} is not a multiple of "
                             f"the window {w}")
        T, hidden = side * side, int(C * cfg["mlp_ratio"])
        out["blocks"] += depth * (T * C * 3 * C         # qkv
                                  + 2 * T * w * w * C   # q kᵀ, p v
                                  + T * C * C           # proj
                                  + 2 * T * C * hidden)  # fc1, fc2
        if s < len(cfg["depths"]) - 1:
            side //= 2
            out["merge"] += side * side * 4 * C * 2 * C
            C *= 2
    out["head"] = C * cfg["num_classes"]
    return out


def decoder_macs(cfg: dict) -> Tuple[int, int]:
    """(the PMIM decoder's multiply-adds, trained; the normalised targets'
    banded matmuls, forward only) of one image."""
    D, p = cfg["embed_dim"], cfg["patch_size"]
    C = cfg.get("in_chans", 3)
    S = cfg["img_size"]
    L = (S // p) ** 2
    return L * D * p * p * C, 4 * S * S * S * C


def train_flops_per_image(cfg: dict, phase: str) -> float:
    """FLOPs of one image's training step: forward + backward, with the
    search's decoder and targets."""
    f = forward_macs(cfg)
    rest = sum(v for k, v in f.items() if k != "patch")
    fwd = f["patch"] + rest
    bwd = 2 * rest + f["patch"]
    extra = 0
    if phase == "search" and cfg.get("search", {}).get("decoder"):
        if arch(cfg) != "vit":
            raise ValueError("no FLOP count for a decoder of a "
                             f"{arch(cfg)!r}")
        dec, targets = decoder_macs(cfg)
        fwd += dec
        bwd += 2 * dec
        extra = targets
    return 2.0 * (fwd + bwd + extra)


def attention_calls(cfg: dict, rows: int) -> List[Call]:
    """The attention calls of one microbatch of `rows` images: one a block,
    each block's own heads and head dim. None for a Swin, whose window
    attention launches no attention kernel."""
    if arch(cfg) == "swin":
        return []
    N = tokens(cfg)
    return [(rows, N, _dims(cfg, i)[0], _dims(cfg, i)[1])
            for i in range(cfg["depth"])]


def attention_bound_s(call: Call, peak=H100) -> Tuple[float, float]:
    """(forward, backward) bound in seconds of one bf16 attention call."""
    B, N, H, d = call
    elems, sq = B * N * H * d, B * H * N * N * d
    fwd = max(8 * elems / peak.hbm_bytes_s, 4 * sq / peak.bf16_flops)
    bwd = max(16 * elems / peak.hbm_bytes_s, 10 * sq / peak.bf16_flops)
    return fwd, bwd
