"""Swin dense-step component breakdown by ablation. Port of
scripts/swin_breakdown.py.

Times the dense Swin train step (`core/swin_steps.py:
make_swin_train_step_dense`, AdamW(1e-4), batch 128, bf16 on the card and
fp32 on the CPU) with components stubbed out through the module
attributes that `models/swin.py:swin_forward` looks up at each call:

  full       the real step
  no_attn    `_window_attention` -> the output projection only (isolates
             qkv, the scores, the softmax and the relative-position bias)
  no_roll    `shifted_windows` without its two `torch.roll`s (the cyclic
             shifts become the identity; the shift mask stays): isolates
             the rolls of every shifted block

Each ablation changes the work, so img/s deltas read as "what fraction of
step time lives in that component", not as achievable speedups. Both
stubs are undone in a `finally`, also when a run raises. Runs on the card
unless --cpu asks for the CPU; without a card it raises.

Usage: python -m ofb_tpu_torch.scripts.swin_breakdown [--model swin_tiny]
           [--batch 128] [--steps 20] [--cpu]
Prints a line a run and one JSON line {run: img/s}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from ..models import swin as swin_mod


def attn_stub(p, x, heads, rel_idx, mask):
    """`_window_attention` without attention: the output projection."""
    return swin_mod.linear(p.proj, x)


def shifted_windows_no_roll(h, w: int, shift: int, attend):
    """`shifted_windows` with the cyclic shifts taken out."""
    _, H_, W_, _ = h.shape
    return swin_mod.window_reverse(attend(swin_mod.window_partition(h, w)),
                                   w, H_, W_)


STUBS = {"full": {}, "no_attn": {"_window_attention": attn_stub},
         "no_roll": {"shifted_windows": shifted_windows_no_roll}}


@contextlib.contextmanager
def patched(run: str):
    """`models/swin.py` with the stubs of `run` in place; restored on the
    way out, whatever happens inside."""
    saved = {k: getattr(swin_mod, k) for k in STUBS[run]}
    try:
        for k, fn in STUBS[run].items():
            setattr(swin_mod, k, fn)
        yield
    finally:
        for k, fn in saved.items():
            setattr(swin_mod, k, fn)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="swin_tiny")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from ..bench import _sync
    from ..core.steps import TrainState
    from ..core.swin_steps import make_swin_train_step_dense
    from ..models.registry import create_model
    from .perf_breakdown import dense_optimizer

    bundle = create_model(f"{args.model}_patch4_window7_224_mim",
                          device="cpu" if args.cpu else "cuda",
                          embed_search=True)
    dev = bundle.device
    compute = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cfg = bundle.cfg
    B = args.batch
    imgs = torch.from_numpy(np.random.RandomState(0).rand(
        1, B, cfg.img_size, cfg.img_size, 3).astype(np.float32)).to(dev)
    lbls = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.num_classes, (1, B))).to(dev)

    def run(tag):
        params = swin_mod.Swin(cfg, generator=torch.Generator().manual_seed(
            0)).to(dev)
        tx = dense_optimizer()
        st = TrainState(step=0, params=params, alphas=None, arch=None,
                        opt_state=tx.init(dict(params.named_parameters())))
        step = make_swin_train_step_dense(cfg, tx, compute_dtype=compute,
                                          device=dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        with patched(tag):
            for _ in range(3):
                st, m = step(st, imgs, lbls, gen)
            float(m["loss"])
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                st, m = step(st, imgs, lbls, gen)
            loss = float(m["loss"])
            dt = time.perf_counter() - t0
        if not np.isfinite(loss):
            raise RuntimeError(f"{tag}: non-finite loss {loss}")
        r = B * args.steps / dt
        print(f"{tag:>10}: {r:8.1f} img/s  ({dt / args.steps * 1e3:.1f} "
              f"ms/step)", flush=True)
        return r

    out = {tag: run(tag) for tag in STUBS}
    print(json.dumps({k: round(v, 1) for k, v in out.items()}), flush=True)
    return out


if __name__ == "__main__":
    main()
