"""Evaluation CLI of the port: top-1 / top-5 / loss of a checkpoint on a
validation set (the flags of scripts/eval.py).

An exported checkpoint (`exported: True`, its `model_cfg` in the meta)
runs the dense eval step, its EMA weights with --use-ema; a searched
supernet checkpoint runs the gated eval step (soft accuracy). A Swin
checkpoint (`family: "swin"`) takes the Swin steps: an exported subnet or
a dense Swin (`cli.train_swin_dense`) through the plain forward with the
widths its meta records, a supernet's best/ through the gated one (its
model and search flags from the recorded args; a JAX package directory
without them takes --model and embed search when its alphas hold
per-stage widths). Any of these may be the port's or the JAX package's.

  python -m ofb_tpu_torch.cli.eval --checkpoint runs/exp/best \\
      --data-set IMNET --data-path /data/imagenet [--device cpu]

Under `torchrun` each rank scores its shard of the val set and every rank
reports the whole set's statistics (`core/engine.py:evaluate`).
"""

from __future__ import annotations

import argparse

import torch


def get_args_parser():
    ap = argparse.ArgumentParser("OFB eval (PyTorch port)", add_help=False)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--model", default="deit_small_patch16_224_mim")
    ap.add_argument("--data-path", default="")
    ap.add_argument("--data-set", default="IMNET")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--synthetic-size", type=int, default=2048,
                    help="samples when --data-set SYNTHETIC")
    ap.add_argument("--input-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--use-ema", action="store_true")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) raises without a "
                         "card")
    return ap


def main(args):
    from ..config import DataConfig
    from ..core import checkpoint as ckpt
    from ..core.engine import evaluate
    from ..core.steps import make_eval_step, make_eval_step_dense
    from ..core.swin_steps import (make_swin_eval_step,
                                   make_swin_eval_step_dense)
    from ..data.datasets import build_dataset
    from ..data.pipeline import device_feed, make_epoch_loader
    from ..models.vit import ModelCfg, ViT
    from .common import (distributed_setup, supernet_bundle,
                         swin_supernet_bundle)

    rank, world, dev = distributed_setup(args.device)
    compute = torch.bfloat16 if args.compute_dtype == "bfloat16" \
        else torch.float32
    meta = ckpt.latest_meta(args.checkpoint)
    if meta is None:
        raise SystemExit(f"no checkpoint at {args.checkpoint}")
    swin = meta.get("family") == "swin"

    # the restored model's img_size sets the eval input size
    input_size = args.input_size
    if meta.get("exported"):
        if "model_cfg" not in meta:
            raise SystemExit(f"{args.checkpoint} has no model_cfg in its "
                             "meta; export it again")
        input_size = meta["model_cfg"].get("img_size", input_size)

    dcfg = DataConfig(data_path=args.data_path, data_set=args.data_set,
                      input_size=input_size, batch_size=args.batch_size,
                      synthetic_size=args.synthetic_size)
    ds_val, nb_classes = build_dataset(False, dcfg, staging=256)

    if swin and meta.get("exported"):
        params, cfg = ckpt.swin_from_meta(meta, dev)
        ckpt.load_checkpoint(args.checkpoint, params=params)
        step = make_swin_eval_step_dense(cfg, compute_dtype=compute,
                                         device=dev)
        state_args = (params,)
    elif swin:
        bundle = swin_supernet_bundle(
            meta.get("args", {}), args.model, nb_classes, dev,
            embed_search=_has_stage_embeds(args.checkpoint, meta))
        input_size = bundle.cfg.img_size
        params, alphas, arch = bundle.init(0)
        ckpt.load_checkpoint(args.checkpoint, params=params, alphas=alphas,
                             arch=arch)
        step = make_swin_eval_step(bundle.space, bundle.cfg,
                                   compute_dtype=compute, device=dev)
        state_args = (params, alphas, arch)
    elif meta.get("exported"):
        cfg = ckpt.model_cfg_from_meta(meta["model_cfg"], ModelCfg)
        # the weights come from the checkpoint: built on the device,
        # unseeded
        params = ViT(cfg, device=dev)
        ema = ViT(cfg, device=dev) if "ema" in meta.get("parts", []) \
            else None
        restored = ckpt.load_checkpoint(args.checkpoint, params=params,
                                        ema_params=ema)
        use = "ema" if args.use_ema and "ema" in restored else "params"
        step = make_eval_step_dense(cfg, compute_dtype=compute, device=dev)
        state_args = (restored[use],)
    else:
        bundle = supernet_bundle(meta.get("args", {}), args.model,
                                 nb_classes, dev)
        input_size = bundle.cfg.img_size
        params, alphas, arch = bundle.init(0)
        ckpt.load_checkpoint(args.checkpoint, params=params, alphas=alphas,
                             arch=arch)
        step = make_eval_step(bundle.space, bundle.cfg,
                              compute_dtype=compute, device=dev)
        state_args = (params, alphas, arch)

    loader = make_epoch_loader(ds_val, epoch=0, rank=rank, world=world,
                               batch_size=args.batch_size,
                               repeated_aug=False, train=False)
    feed = device_feed(loader, train=False, out_size=input_size, device=dev)
    stats = evaluate(step, feed, *state_args)
    print(stats)
    return stats


def _has_stage_embeds(path: str, meta) -> bool:
    """Whether a Swin supernet checkpoint's alphas hold per-stage residual
    widths (read from a JAX package directory, whose meta records no
    args)."""
    from ..core import checkpoint as ckpt
    if "args" in meta or not ckpt.is_jax_checkpoint(path, meta):
        return False
    import os
    from ..core.msgpack import read_tree
    return "stage_embeds" in read_tree(os.path.join(path, "alphas.msgpack"))


if __name__ == "__main__":
    main(argparse.ArgumentParser("OFB eval (PyTorch port)",
                                 parents=[get_args_parser()]).parse_args())
