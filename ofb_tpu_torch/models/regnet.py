"""RegNetY, the inference-only CNN teacher of knowledge distillation.

Port of ofb_tpu/models/regnet.py. The reference's default KD teacher is
timm `regnety_160`. An `nn.Module` whose frozen parameters follow the JAX
tree's names (`stem.conv.weight` OIHW, the folded-BN affines `bn*.weight` /
`bias`, `se_fc*` and `head` as linear layers), so `from_jax.load_from_jax`
fills it from a JAX RegNet tree:

  * the convolutions are cuDNN calls (channels-last activations), the
    grouped 3x3 with `groups`; the JAX package wrote no Pallas kernel here;
  * BatchNorm is inference-only, folded at import into a per-channel affine
    (scale, bias): conv -> affine -> relu;
  * `torch_regnet_to_params` loads a timm RegNetY state dict (BN folded in
    float64, as the JAX package does).

Architecture (pycls RegNetY): stem conv3x3/2, four stages of bottleneck-Y
blocks (1x1 -> grouped 3x3/stride -> SE(0.25 * block input) -> 1x1,
residual + ReLU), global average pool, linear head. regnety_160 = depths
(2, 4, 11, 1), widths (224, 448, 1232, 3024), group width 112, stem 32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class RegNetCfg:
    depths: Tuple[int, ...]
    widths: Tuple[int, ...]
    group_width: int
    stem_width: int = 32
    se_ratio: float = 0.25
    num_classes: int = 1000
    bn_eps: float = 1e-5

    @property
    def num_stages(self) -> int:
        return len(self.depths)


REGNET_CFGS = {
    # pycls / timm model zoo parameterisations
    "regnety_040": RegNetCfg(depths=(2, 6, 12, 2),
                             widths=(128, 192, 512, 1088), group_width=64),
    "regnety_080": RegNetCfg(depths=(2, 4, 10, 1),
                             widths=(168, 448, 896, 2016), group_width=56),
    "regnety_160": RegNetCfg(depths=(2, 4, 11, 1),
                             widths=(224, 448, 1232, 3024), group_width=112),
    "regnety_320": RegNetCfg(depths=(2, 5, 12, 1),
                             widths=(232, 696, 1392, 3712),
                             group_width=232),
}


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Conv(nn.Module):
    """A bias-free convolution weight (out, in / groups, kh, kw), He init."""

    def __init__(self, cin, cout, k, groups, generator, device):
        super().__init__()
        fan_in = k * k * cin // groups
        self.weight = _frozen(torch.randn(
            (cout, cin // groups, k, k), generator=generator,
            device=device) * float(np.sqrt(2.0 / fan_in)))


class _Affine(nn.Module):
    """A folded inference BatchNorm: identity until real stats load."""

    def __init__(self, c, device):
        super().__init__()
        self.weight = _frozen(torch.ones(c, device=device))
        self.bias = _frozen(torch.zeros(c, device=device))


def _fc(cin, cout, std, generator, device) -> nn.Linear:
    m = nn.Linear(cin, cout, device=device)
    with torch.no_grad():
        m.weight.copy_(torch.randn((cout, cin), generator=generator,
                                   device=device) * std)
        m.bias.zero_()
    m.requires_grad_(False)
    return m


class _Stem(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        self.conv = _Conv(3, cfg.stem_width, 3, 1, generator, device)
        self.bn = _Affine(cfg.stem_width, device)


class _BlockY(nn.Module):
    def __init__(self, w_in, w_out, cfg, first, generator, device):
        super().__init__()
        g = w_out // cfg.group_width
        se_c = max(1, int(round(cfg.se_ratio * w_in)))
        self.conv1 = _Conv(w_in, w_out, 1, 1, generator, device)
        self.bn1 = _Affine(w_out, device)
        self.conv2 = _Conv(w_out, w_out, 3, g, generator, device)
        self.bn2 = _Affine(w_out, device)
        self.se_fc1 = _fc(w_out, se_c, 0.01, generator, device)
        self.se_fc2 = _fc(se_c, w_out, 0.01, generator, device)
        self.conv3 = _Conv(w_out, w_out, 1, 1, generator, device)
        self.bn3 = _Affine(w_out, device)
        if first:
            self.down_conv = _Conv(w_in, w_out, 1, 1, generator, device)
            self.down_bn = _Affine(w_out, device)
        self.groups = g


class RegNetY(nn.Module):
    """A frozen RegNetY: `forward(x)` takes (B, H, W, 3) NHWC images and
    returns fp32 logits (B, num_classes), computed in `compute_dtype`."""

    def __init__(self, cfg: RegNetCfg, generator=None, device=None,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.stem = _Stem(cfg, generator, device)
        self.stages = nn.ModuleList()
        w_in = cfg.stem_width
        for s in range(cfg.num_stages):
            w_out = cfg.widths[s]
            self.stages.append(nn.ModuleList(
                _BlockY(w_in if b == 0 else w_out, w_out, cfg, b == 0,
                        generator, device)
                for b in range(cfg.depths[s])))
            w_in = w_out
        self.head = _fc(cfg.widths[-1], cfg.num_classes, 0.01, generator,
                        device)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        # NCHW shapes in channels-last memory, the layout cuDNN prefers
        h = x.to(dt).permute(0, 3, 1, 2)
        h = F.relu(_bn(self.stem.bn, _conv(self.stem.conv, h, 2, 1)))
        for blocks in self.stages:
            for b, blk in enumerate(blocks):
                h = _block(blk, h, 2 if b == 0 else 1)
        feat = h.mean(dim=(2, 3))
        return F.linear(feat, self.head.weight.to(dt),
                        self.head.bias.to(dt)).float()


def _conv(p: _Conv, x, stride, groups):
    w = p.weight.to(x.dtype)
    k = w.shape[-1]
    # symmetric k // 2 padding (torch / timm semantics)
    return F.conv2d(x, w, None, stride, k // 2, 1, groups)


def _bn(p: _Affine, x):
    return x * p.weight.to(x.dtype)[:, None, None] \
        + p.bias.to(x.dtype)[:, None, None]


def _block(p: _BlockY, x, stride):
    h = F.relu(_bn(p.bn1, _conv(p.conv1, x, 1, 1)))
    h = F.relu(_bn(p.bn2, _conv(p.conv2, h, stride, p.groups)))
    # SE on the grouped conv's output, squeezed over H, W
    s = h.mean(dim=(2, 3))
    s = F.relu(F.linear(s, p.se_fc1.weight.to(h.dtype),
                        p.se_fc1.bias.to(h.dtype)))
    s = torch.sigmoid(F.linear(s, p.se_fc2.weight.to(h.dtype),
                               p.se_fc2.bias.to(h.dtype)))
    h = h * s[:, :, None, None]
    h = _bn(p.bn3, _conv(p.conv3, h, 1, 1))
    if hasattr(p, "down_conv"):
        x = _bn(p.down_bn, _conv(p.down_conv, x, stride, 1))
    return F.relu(x + h)


def init_regnet(cfg: RegNetCfg, seed: int = 7, device=None,
                compute_dtype=torch.bfloat16) -> RegNetY:
    """A RegNetY with weights from `seed` (He-normal convs, 0.01 normal SE
    and head, identity affines), drawn on the CPU and moved to `device`, so
    a seed gives the same model on every device."""
    gen = torch.Generator().manual_seed(seed)
    return RegNetY(cfg, gen, None, compute_dtype).to(device)


# ---------------------------------------------------------------------------
# timm-format weight import
# ---------------------------------------------------------------------------

def _fold_bn(sd, prefix, eps) -> Dict[str, np.ndarray]:
    """A torch BatchNorm's running stats -> the folded affine, in float64
    then fp32."""
    g = np.asarray(sd[prefix + ".weight"], np.float64)
    b = np.asarray(sd[prefix + ".bias"], np.float64)
    m = np.asarray(sd[prefix + ".running_mean"], np.float64)
    v = np.asarray(sd[prefix + ".running_var"], np.float64)
    scale = g / np.sqrt(v + eps)
    return {"weight": scale.astype(np.float32),
            "bias": (b - m * scale).astype(np.float32)}


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def torch_regnet_to_params(sd: Dict, cfg: RegNetCfg,
                           model: RegNetY) -> RegNetY:
    """Load a timm RegNetY state dict (stem.conv / stem.bn, s{1..4}.b{1..N}
    conv1..3 .conv / .bn, se.fc1 / fc2, downsample.conv / .bn, head.fc)
    into `model`, in place; returns `model`. Raises on a missing key or a
    shape that differs."""
    sd = {k: _np(v) for k, v in sd.items()}
    eps = cfg.bn_eps
    flat: Dict[str, np.ndarray] = {}

    def conv(dst, src):
        flat[dst + ".weight"] = sd[src + ".weight"]

    def bn(dst, src):
        for k, v in _fold_bn(sd, src, eps).items():
            flat[f"{dst}.{k}"] = v

    def fc(dst, src):
        w = sd[src + ".weight"]
        flat[dst + ".weight"] = w[:, :, 0, 0] if w.ndim == 4 else w
        flat[dst + ".bias"] = sd[src + ".bias"]

    conv("stem.conv", "stem.conv")
    bn("stem.bn", "stem.bn")
    for s in range(cfg.num_stages):
        for b in range(cfg.depths[s]):
            pre, dst = f"s{s + 1}.b{b + 1}", f"stages.{s}.{b}"
            for i in (1, 2, 3):
                conv(f"{dst}.conv{i}", f"{pre}.conv{i}.conv")
                bn(f"{dst}.bn{i}", f"{pre}.conv{i}.bn")
            fc(f"{dst}.se_fc1", f"{pre}.se.fc1")
            fc(f"{dst}.se_fc2", f"{pre}.se.fc2")
            if pre + ".downsample.conv.weight" in sd:
                conv(f"{dst}.down_conv", f"{pre}.downsample.conv")
                bn(f"{dst}.down_bn", f"{pre}.downsample.bn")
    fc("head", "head.fc")
    named = dict(model.named_parameters())
    if set(flat) != set(named):
        raise KeyError(
            f"RegNetY state dict and model differ: only in the state dict "
            f"{sorted(set(flat) - set(named))[:6]}, only in the model "
            f"{sorted(set(named) - set(flat))[:6]}")
    with torch.no_grad():
        for n, p in named.items():
            src = torch.from_numpy(np.asarray(flat[n], np.float32))
            if src.shape != p.shape:
                raise ValueError(f"{n}: state dict {tuple(src.shape)}, "
                                 f"model {tuple(p.shape)}")
            p.copy_(src.to(p.device))
    return model
