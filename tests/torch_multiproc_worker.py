"""Worker of tests/test_torch_port_multiprocess.py: one rank of a gloo
process group on the CPU, rendezvous through a `file://` store.

  python tests/torch_multiproc_worker.py CASE RANK WORLD RDZV DATA OUT

CASE 'search': K search steps of the tiny supernet (explicit token masks,
no Mixup) on this rank's rows of the global batch, then a compress pass
(rank 0 alone crafts a converged MLP alpha: the other ranks must take its
decisions), then an eval over this rank's shard of the val set. CASE
'mixup': K postsearch steps (Mixup in 'elem' mode, drop-path, the fused
augment, every draw from one seeded generator). The state after the steps
goes to OUT/rank<R>.npz and one JSON line (compress digest, eval
statistics, metrics) to stdout. The test runs the same functions in its
own process, without a group, on the whole batch (`run(case, data)`).
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)
K, A = 2, 2


def search_cfg(C, *, phase="search"):
    """The search config of both cases, from a config module (the port's
    or the JAX package's: the same fields); learning rates absolute, so
    the world's batch does not move them."""
    fam = C.OptimFamilyConfig(lr=2e-3)
    cfg = C.SearchConfig(
        accum_iter=A, target_flops=0.0002, clip_grad=1.0, w_patch=0.3,
        model_ema=True, model_ema_decay=0.9, optim_param=fam,
        optim_decoder=fam,
        optim_arch=C.OptimFamilyConfig(lr=2e-2, betas=(0.5, 0.999)),
        schedule=C.ScheduleConfig(warmup_epochs=1, warmup_lr=1e-4,
                                  min_lr=1e-5))
    if phase == "postsearch":
        cfg.mixup = C.MixupConfig(mode="elem", label_smoothing=0.1)
    return cfg


def build_tx(O, scfg):
    return O.build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=40, steps_per_epoch=4, clip_grad=scfg.clip_grad,
        accum_iter=scfg.accum_iter)


def state_arrays(state):
    """{name: array} of the leaves, the EMA and the step counter."""
    from ofb_tpu_torch.core.optim import named_leaves
    out = {n: p.detach().numpy().copy()
           for n, p in named_leaves(state.params, state.alphas).items()}
    out.update({"ema." + n: t.numpy().copy()
                for n, t in state.ema_params.items()})
    out["step"] = np.asarray(int(state.step))
    return out


def arch_digest(events, *trees) -> str:
    """sha256 of the compress events and every tensor of `trees`."""
    from ofb_tpu_torch.core.steps import named_tensors
    h = hashlib.sha256(repr(events).encode())
    for tree in trees:
        for _, t in named_tensors(tree):
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def run(case, data, rank=0, world=1):
    """One rank's part of `case` on `data` (the npz the test wrote);
    returns (state arrays, JSON-able result)."""
    from ofb_tpu_torch import config as C
    from ofb_tpu_torch.core import optim as O
    from ofb_tpu_torch.core.compress import compress
    from ofb_tpu_torch.core.engine import evaluate
    from ofb_tpu_torch.core.steps import (TrainState, make_eval_step,
                                          make_search_step)
    from ofb_tpu_torch.data.samplers import distributed_indices
    from ofb_tpu_torch.models.mim_vit import Alphas, MimViT
    from ofb_tpu_torch.models.search_space import ArchState, SearchSpace
    from ofb_tpu_torch.models.vit import ModelCfg
    from ofb_tpu_torch.parallel.mesh import local_rows

    cfg = ModelCfg(**json.loads(str(data["cfg"])))
    space = SearchSpace.build(cfg.embed_dim, cfg.depth, cfg.num_heads,
                              cfg.hidden, cfg.num_patches, patch_search=True)
    params, alphas = MimViT(cfg, space), Alphas(space)
    with torch.no_grad():
        for prefix, mod in (("p.", params), ("a.", alphas)):
            for n, p in mod.named_parameters():
                p.copy_(torch.from_numpy(data[prefix + n]))
    arch = ArchState.create(space)
    phase = "postsearch" if case == "mixup" else "search"
    scfg = search_cfg(C, phase=phase)
    tx, _ = build_tx(O, scfg)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(O.named_leaves(params, alphas)),
                       ema_params={n: p.detach().clone()
                                   for n, p in params.named_parameters()})
    step = make_search_step(space, cfg, scfg, tx, phase=phase,
                            compute_dtype=torch.float32,
                            fused_augment=case == "mixup", device="cpu")

    def rows(x):
        return local_rows(torch.from_numpy(x), rank, world, dim=1)

    metrics = []
    gen = torch.Generator().manual_seed(123)
    for k in range(K):
        if case == "mixup":
            state, m = step(state, rows(data["images"][k]),
                            rows(data["labels"][k]), gen)
        else:
            state, m = step(state, rows(data["images"][k]),
                            rows(data["labels"][k]), None,
                            float(data["keep"]),
                            token_masks=torch.from_numpy(data["masks"][k]))
        metrics.append({n: float(v) for n, v in m.items()})
    arrays = state_arrays(state)
    result = {"metrics": metrics}
    if case != "search":
        return arrays, result

    # compress: only rank 0 holds the converged alpha; every rank must
    # take rank 0's decisions
    if rank == 0:
        a = torch.full_like(alphas.blocks[0].mlp, -8.0)
        a.view(-1)[1] = 8.0
        with torch.no_grad():
            alphas.blocks[0].mlp.copy_(a)
    _, _, arch, _, rep = compress(params, alphas, arch, state.opt_state,
                                  space, 0.2)
    assert rep.events, "the crafted alpha gives a prune event"
    result["events"] = rep.events
    result["digest"] = arch_digest(rep.events, alphas, arch)

    # eval over this rank's shard of the val set
    vi, vl = data["val_images"], data["val_labels"]
    idx = distributed_indices(len(vi), 0, rank, world, shuffle=False)
    feed = [(torch.from_numpy(vi[idx[i:i + 8]]),
             torch.from_numpy(vl[idx[i:i + 8]]))
            for i in range(0, len(idx), 8)]
    ev = make_eval_step(space, cfg, compute_dtype=torch.float32,
                        device="cpu")
    result["eval"] = evaluate(ev, feed, params, alphas, arch,
                              print_fn=lambda *a, **k: None)
    return arrays, result


def main():
    case, rank, world, rdzv, data, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    import torch.distributed as dist

    from ofb_tpu_torch.parallel.distributed import init_distributed
    assert init_distributed(device="cpu", init_method=f"file://{rdzv}") \
        == (rank, world)
    arrays, result = run(case, np.load(data), rank, world)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    print(json.dumps(result), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
