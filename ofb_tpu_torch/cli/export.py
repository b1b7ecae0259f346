"""Export CLI of the port: a searched supernet checkpoint -> a compact dense
checkpoint (the flags of scripts/export.py).

Restores the supernet the search run recorded (a checkpoint of the port's
or of the JAX package's), force-finishes an
unconverged search with compress(thresh=1.0) (up to 20 passes), slices the
subnet out (`core/export.py:export_subnet`) and saves it with `exported:
True` and its `model_cfg` in the meta.

  python -m ofb_tpu_torch.cli.export --checkpoint runs/exp/best \\
      --out runs/exp/exported [--device cpu]

Under `torchrun` every rank exports the same subnet and rank 0 writes it.
"""

from __future__ import annotations

import argparse
import dataclasses


def get_args_parser():
    ap = argparse.ArgumentParser("OFB export (PyTorch port)", add_help=False)
    ap.add_argument("--checkpoint", required=True,
                    help="searched supernet checkpoint dir")
    ap.add_argument("--out", required=True, help="output checkpoint dir")
    ap.add_argument("--model", default="deit_small_patch16_224_mim")
    ap.add_argument("--num-classes", type=int, default=None,
                    help="override; default from the search run's dataset "
                         "(1000 if unknown)")
    ap.add_argument("--no-fuse", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) raises without a "
                         "card")
    return ap


def main(args):
    from ..core import checkpoint as ckpt
    from ..core.compress import compress
    from ..core.export import export_subnet, exported_param_count
    from .common import (classes_from_args, distributed_setup,
                         supernet_bundle)

    _, _, dev = distributed_setup(args.device)
    meta = ckpt.latest_meta(args.checkpoint)
    if meta is None:
        raise FileNotFoundError(f"no checkpoint at {args.checkpoint}")
    saved_args = meta.get("args", {})
    nb_classes = args.num_classes if args.num_classes is not None \
        else classes_from_args(saved_args)
    bundle = supernet_bundle(saved_args, args.model, nb_classes, dev)
    params, alphas, arch = bundle.init(0)
    ckpt.load_checkpoint(args.checkpoint, params=params, alphas=alphas,
                         arch=arch)

    guard = 0
    while not arch.all_finished and guard < 20:
        params, alphas, arch, _, rep = compress(params, alphas, arch, None,
                                                bundle.space, thresh=1.0)
        guard += 1
        print("force-finish:", "; ".join(rep.events) or "(no event)")

    dense, dense_cfg, export_meta = export_subnet(
        params, arch, bundle.space, bundle.cfg, fuse=not args.no_fuse)
    n = exported_param_count(dense)
    print(f"exported model: D={dense_cfg.embed_dim}, "
          f"blocks={dense_cfg.block_overrides}, params={n / 1e6:.2f}M")
    ckpt.save_checkpoint(args.out, params=dense, meta={
        "exported": True, "model_cfg": dataclasses.asdict(dense_cfg),
        "export": export_meta, "source": args.checkpoint,
        "params_m": n / 1e6})
    ckpt.commit_saves("export written")
    print(f"saved to {args.out}")
    return dense, dense_cfg


if __name__ == "__main__":
    main(argparse.ArgumentParser("OFB export (PyTorch port)",
                                 parents=[get_args_parser()]).parse_args())
