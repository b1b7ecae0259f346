"""Worker of tests/test_torch_port_tensor_parallel.py: one rank of a gloo
process group on the CPU, on a (data, model) mesh, rendezvous through a
`file://` store.

  python tests/torch_tp_worker.py RANK WORLD DP TP RDZV DATA OUT [FROM]

On the tiny supernet of DATA (an npz the test wrote: config, weights in the
port's layout, the global batches, the PMIM masks JAX draws or the seed of
a generator to draw every mask from, and the path of a checkpoint the JAX
package wrote from the same supernet): the
supernet cut into this rank's shards (`shard_params`), a search step, a
forced compress event (block 0's MLP alpha cell 0 at -8), a checkpoint of
that state (OUT/resume), a post-prune step, then the same step resumed
from that checkpoint in a fresh sharded supernet, a forced convergence and
the export; beside them the gradient clip of sharded leaves, a checkpoint
of the sharded state after the post-prune step (OUT/ckpt) and the JAX
package's checkpoint restored into a fresh sharded supernet. The gathered
leaves, moments, export and clip go to OUT/rank<R>.npz and one JSON line
(metrics, compress events, switch digest, an eval of the data rank's shard
of a val set) to stdout. The test runs `run(data)` in its own process,
without a group, on the whole batch. With FROM the rank only resumes the
post-prune step from the checkpoint at FROM (`resume`), as a resume on
another mesh than the one that saved it.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_multiproc_worker as W  # noqa: E402

torch.set_num_threads(1)


def clip_grads(data):
    """{name: full gradient} of every leaf from a seed: the clip's input."""
    g = torch.Generator().manual_seed(31)
    return {n[2:]: torch.randn(data[n].shape, generator=g)
            for n in data.files if n.startswith("p.")}


def build(data, mesh=None, seed=None):
    """(cfg, space, state, step) of DATA's supernet, its weights (or, with
    `seed`, weights drawn from `seed` for a restore to overwrite) cut into
    this rank's shards on `mesh`'s model axis; AdamW's state and an EMA of
    the (sharded) weights."""
    from ofb_tpu_torch import config as C
    from ofb_tpu_torch.core import optim as O
    from ofb_tpu_torch.core.steps import TrainState, make_search_step
    from ofb_tpu_torch.models.mim_vit import Alphas, MimViT
    from ofb_tpu_torch.models.search_space import ArchState, SearchSpace
    from ofb_tpu_torch.models.vit import ModelCfg
    from ofb_tpu_torch.parallel import mesh as M

    cfg = ModelCfg(**json.loads(str(data["cfg"])))
    space = SearchSpace.build(cfg.embed_dim, cfg.depth, cfg.num_heads,
                              cfg.hidden, cfg.num_patches, patch_search=True)
    g = torch.Generator().manual_seed(seed or 0)
    params, alphas = MimViT(cfg, space, generator=g), Alphas(space,
                                                             generator=g)
    if seed is None:
        with torch.no_grad():
            for prefix, mod in (("p.", params), ("a.", alphas)):
                for n, p in mod.named_parameters():
                    p.copy_(torch.from_numpy(data[prefix + n]))
    if mesh is not None:
        M.shard_params(params, mesh)
    scfg = W.search_cfg(C)
    tx, _ = W.build_tx(O, scfg)
    state = TrainState(step=0, params=params, alphas=alphas,
                       arch=ArchState.create(space),
                       opt_state=tx.init(O.named_leaves(params, alphas)),
                       ema_params={n: p.detach().clone()
                                   for n, p in params.named_parameters()})
    step = make_search_step(space, cfg, scfg, tx, phase="search",
                            compute_dtype=torch.float32, device="cpu")
    return cfg, space, state, step


def gathered(state, tag, moments=("mu",), ema=False):
    """{tag.name: full array} of the leaves (and the moments `moments`,
    and with `ema` the EMA) of a state, gathered on a mesh."""
    from ofb_tpu_torch.core import optim as O
    from ofb_tpu_torch.parallel import mesh as M
    layout = M.tp_of(state.params)
    parts = {"": {n: p.detach() for n, p in
                  O.named_leaves(state.params, state.alphas).items()}}
    parts.update({f"{m}.": dict(getattr(state.opt_state, m))
                  for m in moments})
    if ema:
        parts["ema."] = dict(state.ema_params)
    return {f"{tag}.{k}{n}": t.numpy().copy()
            for k, part in parts.items()
            for n, t in M.gather_named(part, layout).items()}


def take_step(step, state, data, k, gen=None):
    """Step `k` of DATA (this data rank's rows; DATA's masks, or draws from
    `gen`) on `state`; returns its metrics."""
    from ofb_tpu_torch.parallel import mesh as M
    from ofb_tpu_torch.parallel.distributed import data_rank_world
    drank, dworld = data_rank_world()

    def rows(x):
        return M.local_rows(torch.from_numpy(x), drank, dworld, dim=1)

    _, m = step(state, rows(data["images"][k]), rows(data["labels"][k]), gen,
                float(data["keep"]),
                token_masks=None if gen is not None
                else torch.from_numpy(data["masks"][k]))
    return {n: float(v) for n, v in m.items()}


def restored(data, path, mesh=None):
    """A fresh supernet of DATA's config (other weights), sharded on
    `mesh`, with the checkpoint at `path` restored into it: its state and
    the checkpoint's meta."""
    from ofb_tpu_torch.core.checkpoint import load_checkpoint
    _, _, state, step = build(data, mesh, seed=99)
    meta = load_checkpoint(path, params=state.params, alphas=state.alphas,
                           arch=state.arch, opt_state=state.opt_state,
                           ema_params=state.ema_params)["meta"]
    return state, step, meta


def resume(data, path, mesh=None):
    """The post-prune step resumed from the checkpoint at `path` in a fresh
    supernet sharded on `mesh` (one process without): ({"resumed.<name>":
    gathered leaf, moment or EMA}, the step's metrics)."""
    state, step, meta = restored(data, path, mesh)
    state.step.fill_(meta["step"])
    metrics = take_step(step, state, data, 1)
    return gathered(state, "resumed", ("mu", "nu"), ema=True), metrics


def run(data, dp=1, tp=1, rank=0, world=1, out=None):
    """This rank's part on `data`; returns ({name: array}, JSON-able
    result). dp * tp == world; world 1 runs without a mesh."""
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch import config as C
    from ofb_tpu_torch.core import optim as O
    from ofb_tpu_torch.core.checkpoint import commit_saves, save_checkpoint
    from ofb_tpu_torch.core.compress import compress
    from ofb_tpu_torch.core.engine import evaluate
    from ofb_tpu_torch.core.export import export_subnet
    from ofb_tpu_torch.core.steps import make_eval_step
    from ofb_tpu_torch.data.samplers import distributed_indices
    from ofb_tpu_torch.parallel import mesh as M
    from ofb_tpu_torch.parallel.distributed import data_rank_world

    mesh = M.make_mesh((dp, tp)) if world > 1 else None
    cfg, space, state, step = build(data, mesh)
    params, alphas = state.params, state.alphas
    full = {n: torch.from_numpy(data["p." + n])
            for n, _ in params.named_parameters()}
    result = {}
    if mesh is not None:
        back = M.gather_params(params)
        result["gather_identity"] = all(
            torch.equal(p, full[n]) for n, p in back.named_parameters())
        result["sharded"] = sorted(
            n for n, p in params.named_parameters()
            if p.shape != full[n].shape)
    scfg = W.search_cfg(C)
    drank, dworld = data_rank_world()
    layout = M.tp_of(params)
    arrays, metrics = {}, []

    # with "gen_seed" every draw (PMIM masks, dropout, attention dropout,
    # drop-path) comes from one seeded generator, else the masks JAX drew
    gen = torch.Generator().manual_seed(int(data["gen_seed"])) \
        if "gen_seed" in data.files else None

    metrics.append(take_step(step, state, data, 0, gen))
    arrays.update(gathered(state, "step0"))

    # the forced compress event, as the JAX dry run makes it
    with torch.no_grad():
        alphas.blocks[0].mlp[..., 0] = -8.0
    _, _, arch, _, rep = compress(state.params, alphas, state.arch,
                                  state.opt_state, space,
                                  scfg.compress_thresh)
    result["events"] = rep.events
    h = hashlib.sha256()
    for b in arch.blocks:
        for t in (b.attn.switch, b.mlp.switch):
            h.update(t.numpy().astype(np.uint8).tobytes())
    result["switch_digest"] = h.hexdigest()
    arrays.update({f"switch.{i}.{k}": getattr(b, k).switch.numpy().copy()
                   for i, b in enumerate(arch.blocks)
                   for k in ("attn", "mlp")})

    # the state before the post-prune step, saved (gathered: one file in
    # the one-process format) and fenced before any rank reads it
    resume_at = out is not None and gen is None
    if resume_at:
        save_checkpoint(os.path.join(out, "resume"), params=state.params,
                        alphas=state.alphas, arch=state.arch,
                        opt_state=state.opt_state,
                        ema_params=state.ema_params,
                        meta={"step": int(state.step)})
        commit_saves()

    metrics.append(take_step(step, state, data, 1, gen))
    arrays.update(gathered(state, "step1", ("mu", "nu") if resume_at
                           else ("mu",), ema=resume_at))
    if resume_at:
        # the same step resumed in a fresh supernet on this mesh
        got, result["resumed"] = resume(data, os.path.join(out, "resume"),
                                        mesh)
        arrays.update(got)

    # an eval of this data rank's shard of the val set: every rank reports
    # the whole set's statistics (the data group's sums)
    vi, vl = data["images"][0, 0], data["labels"][0, 0]
    idx = distributed_indices(len(vi), 0, drank, dworld, shuffle=False)
    ev = make_eval_step(space, cfg, compute_dtype=torch.float32,
                        device="cpu")
    result["eval"] = evaluate(
        ev, [(torch.from_numpy(vi[idx]), torch.from_numpy(vl[idx]))],
        state.params, state.alphas, state.arch,
        print_fn=lambda *a, **k: None)
    ema = M.gather_named(state.ema_params, layout)
    arrays.update({f"ema.{n}": t.numpy().copy() for n, t in ema.items()})
    result["metrics"] = metrics

    # the checkpoint of the sharded state is the one-process format
    if out is not None:
        save_checkpoint(os.path.join(out, "ckpt"), params=state.params,
                        alphas=state.alphas, arch=state.arch,
                        opt_state=state.opt_state,
                        ema_params=state.ema_params)

    # the JAX package's checkpoint of the same supernet, restored into a
    # fresh sharded one
    if "jax_ckpt" in data.files:
        jstate, _, _ = restored(data, str(data["jax_ckpt"]), mesh)
        arrays.update(gathered(jstate, "jaxck", ("mu", "nu"), ema=True))
        result["jaxck_count"] = int(jstate.opt_state.count)
        del jstate

    # forced convergence, then the export (gathered on a mesh)
    report = B.force_convergence(state, space)[0]
    result["finished"] = bool(report.finish_search)
    dense, dcfg, _ = export_subnet(state.params, state.arch, space, cfg)
    arrays.update({f"export.{n}": p.detach().numpy().copy()
                   for n, p in dense.named_parameters()})
    result["block_dims"] = [list(b) for b in dcfg.block_overrides]

    # the clip of sharded leaves against the whole ones'
    grads = clip_grads(data)
    names = sorted(grads)
    local = [M.shard_tensor(n, grads[n], layout) if layout else grads[n]
             for n in names]
    clipped = O._clip(local, 0.5, [layout is not None
                                   and M.shard_kind(n) is not None
                                   for n in names])
    got = M.gather_named(dict(zip(names, clipped)), layout)
    arrays.update({f"clip.{n}": t.numpy().copy() for n, t in got.items()})
    return arrays, result


def main():
    rank, world, dp, tp = (int(a) for a in sys.argv[1:5])
    rdzv, data, out = sys.argv[5:8]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    import torch.distributed as dist

    from ofb_tpu_torch.parallel.distributed import init_distributed
    from ofb_tpu_torch.parallel.mesh import make_mesh
    assert init_distributed(device="cpu", init_method=f"file://{rdzv}") \
        == (rank, world)
    if len(sys.argv) > 8:          # a resume from another mesh's checkpoint
        arrays, metrics = resume(np.load(data), sys.argv[8],
                                 make_mesh((dp, tp)))
        result = {"resumed": metrics}
    else:
        arrays, result = run(np.load(data), dp, tp, rank, world, out)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    print(json.dumps(result), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
