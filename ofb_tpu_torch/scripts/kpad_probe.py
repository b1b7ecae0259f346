"""A/B probe: does zero-padding the contraction dim K of the ViT-shaped
matmuls (384 -> 512) speed them up on this card? Port of
scripts/kpad_probe.py.

The hypothesis carried over from the JAX package: if the padded product
(a third more physical FLOPs) takes *less* wall time, the K-tiling of the
GEMM is the limiter, and the model's qkv / fc weights should carry
zero-padded contraction dims. Each shape runs the chain
`out = (out @ b) @ b.T * 1e-3` for 30 iterations in bf16 (`torch.matmul`:
a plain product, as in the JAX script, no kernel of the port), timed on
the host after one warm-up call and ended by reading back the sum.

Runs on the card unless --device cpu asks for the CPU; without a card it
raises.

Usage: python -m ofb_tpu_torch.scripts.kpad_probe [--device cuda|cpu]
Prints one JSON line per shape with effective TF/s at the LOGICAL flop
count for both variants.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

M_DEIT_S = 256 * 197 // 8 * 8            # DeiT-S batch x tokens, padded
ITERS = 30
SHAPES = (("qkv", 384, 1152), ("proj", 384, 384), ("fc1", 384, 1536),
          ("fc2", 1536, 384), ("deit_b_qkv", 768, 2304))


def padded_k(k: int) -> int:
    """The next 128-multiple above K."""
    return ((k + 127) // 128) * 128 + 128


def operands(m: int, k: int, n: int, kpad: int, device):
    """(x, w, x padded, w padded) in bf16 from a seed."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(m, k)).to(device, torch.bfloat16)
    w = torch.from_numpy(rs.randn(k, n)).to(device, torch.bfloat16)
    return x, w, F.pad(x, (0, kpad - k)), F.pad(w, (0, 0, 0, kpad - k))


def chain(a, b, iters: int):
    out = a
    for _ in range(iters):
        out = (out @ b) @ b.transpose(0, 1) * 1e-3
    return out.sum().float()


def bench_matmul(m: int, k: int, n: int, kpad: int, iters: int = ITERS,
                 device="cuda"):
    """Effective TF/s (logical 2*m*k*n) for K=k and K padded to kpad."""
    from ..bench import _sync
    from ..device import resolve_device
    dev = resolve_device(device)
    x, w, xp, wp = operands(m, k, n, kpad, dev)

    def run(a, b):
        float(chain(a, b, iters))            # warm
        _sync(dev)
        t0 = time.perf_counter()
        s = float(chain(a, b, iters))        # host readback = sync
        dt = time.perf_counter() - t0
        assert np.isfinite(s)
        # each iter does the product and the transposed one: 2 matmuls
        logical = 2 * 2 * m * k * n * iters
        return logical / dt / 1e12

    return run(x, w), run(xp, wp)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lines = []
    for name, K, N in SHAPES:
        kp = padded_k(K)
        base, padded = bench_matmul(M_DEIT_S, K, N, kp, ITERS,
                                    device=args.device)
        line = {"shape": name, "m": M_DEIT_S, "k": K, "n": N, "k_padded": kp,
                "tf_s": round(base, 1),
                "tf_s_padded_effective": round(padded, 1),
                "padded_wins": padded > base * 1.02}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
