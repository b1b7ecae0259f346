"""Device mesh, batch rows and parameter placements.

Port of ofb_tpu/parallel/mesh.py. The reference's only parallelism is DDP
over NCCL: a 1-D 'data' axis, the batch split over it and the state
replicated, the gradients averaged by an all-reduce (which the port's
steps make, `core/steps.py:_averaged`). A second 'model' axis holds the
tensor-parallel shards of the supernet's block matmuls: the search step on
a (data, model) mesh, which the JAX package gets from XLA's SPMD
partitioner and the port from `parallel/tensor_parallel.py`.

  * `make_mesh` — a `DeviceMesh` over the world, (world, 1) by default,
    made the active mesh (`distributed.data_group` / `model_group`);
  * `local_rows` — this rank's rows of a global batch, the order in which
    `jax.make_array_from_process_local_data` assembles the global batch
    from each process's rows (`batch_sharding` / `shard_batch`); the
    data axis's rank and size decide them, so the ranks of one model
    group hold the same rows and draw the same masks;
  * `replicate` — every tensor of a tree from rank 0;
  * `param_sharding_rules` — leaf name -> `Replicate()` / `Shard(dim)` in
    the port's (out, in) weight layout, the JAX package's placements;
  * `shard_params` / `gather_params` — a replicated supernet cut into this
    rank's shards on the model axis, and the full tensors put back;
    `core/checkpoint.py:load_checkpoint` takes the same cut of a saved
    full tensor (`shard_tensor`, `full_shape`) when it restores into a
    sharded supernet.

The shards differ from the JAX package's contiguous `Shard(0)` of the qkv
rows on purpose. Those rows are laid out [3][H][hd], so a contiguous half
would give one rank all of q and half of k; the port gives each rank the
q, k and v rows of its own heads (`TPLayout`). Heads and MLP hidden units
split as `np.array_split` splits them, so any model size up to the head
count runs (DeiT-S's 6 heads on 4 ranks: 2, 2, 1, 1).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .distributed import (broadcast_, collective_device, data_rank_world,
                          group_active, model_group,
                          rank_world, set_active_mesh)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("data", "model")):
    """A DeviceMesh over every rank of the process group: all on 'data',
    'model' = 1 by default. Needs the group up (`init_distributed`)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not group_active():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed() under a launcher first")
    _, n = rank_world()
    if shape is None:
        shape = (n, 1)
    if len(shape) == 1:
        shape = (shape[0], 1)
    assert int(np.prod(shape)) == n, f"mesh {shape} != {n} devices"
    mesh = init_device_mesh(collective_device().type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))
    set_active_mesh(mesh)
    return mesh


def local_rows(global_batch: torch.Tensor, rank: int, world: int,
               dim: int = 0) -> torch.Tensor:
    """Rows [rank * mb, (rank + 1) * mb) of `global_batch` along `dim`
    (mb = its size / world): what rank `rank` contributes to the global
    batch (dim 1 for an (A, B, ...) accumulation batch)."""
    n = global_batch.shape[dim]
    if n % world:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{world} ranks")
    mb = n // world
    return global_batch.narrow(dim, rank * mb, mb)


def replicate(tree):
    """Every tensor of `tree` (modules, dicts, sequences, dataclasses: a
    `TrainState`) takes rank 0's values, in place (one broadcast per
    dtype); returns the tree. The identity without a process group."""
    from ..core.steps import named_tensors
    broadcast_([t for _, t in named_tensors(tree)])
    return tree


def param_sharding_rules(params: torch.nn.Module, *,
                         tensor_parallel: bool = False) -> Dict[str, object]:
    """{parameter name: placement on the 'model' axis}. Data parallel:
    every leaf `Replicate()`. tensor_parallel: the block matmuls split as
    the JAX package splits them, in the (out, in) layout —
      qkv / fc1 weight (out, in) -> Shard(0)    column parallel
      proj / fc2 weight (out, in) -> Shard(1)   row parallel
      qkv / fc1 bias              -> Shard(0)
    and every other leaf Replicate()."""
    from torch.distributed.tensor import Replicate, Shard

    def rule(name: str, leaf: torch.Tensor):
        if not tensor_parallel:
            return Replicate()
        if leaf.dim() == 2:
            if "qkv.weight" in name or "fc1.weight" in name:
                return Shard(0)
            if "proj.weight" in name or "fc2.weight" in name:
                return Shard(1)
        if leaf.dim() == 1 and ("qkv.bias" in name or "fc1.bias" in name):
            return Shard(0)
        return Replicate()

    return {n: rule(n, p) for n, p in params.named_parameters()}


def this_rank_rows(x, dim: int = 0):
    """This rank's rows (`local_rows` at its data-axis rank) of a
    global-batch tensor, or of each tensor field of a NamedTuple of them
    (None fields kept); `x` itself on a data axis of one."""
    rank, world = data_rank_world()
    if world == 1 or x is None:
        return x
    if isinstance(x, tuple):
        return type(x)(*(this_rank_rows(f, dim) for f in x))
    return local_rows(x, rank, world, dim)


def draw_rows(draw, batch: int):
    """This rank's `batch` rows of `draw(batch * data ranks)`, a random draw
    with one leading row per image (a tensor or a NamedTuple of them).
    Every rank draws over the global batch from a generator in the same
    state, so a world of N draws what one process draws for the whole
    batch, and the ranks of a model group draw the same rows."""
    _, world = data_rank_world()
    return this_rank_rows(draw(batch * world))


# ---------------------------------------------------------------------------
# Tensor parallelism: the supernet's block matmuls on the model axis
# ---------------------------------------------------------------------------

def split_sizes(n: int, parts: int, what: str) -> Tuple[int, ...]:
    """`np.array_split`'s sizes of n items over `parts` ranks (the first
    ones one larger); raises when a rank would hold none."""
    if parts > n:
        raise ValueError(f"{what}: {n} cannot split over {parts} model "
                         f"ranks (each rank needs at least one); use a "
                         f"model axis of at most {n}")
    return tuple(len(a) for a in np.array_split(np.arange(n), parts))


@dataclass(frozen=True)
class TPLayout:
    """Where this rank's shards of a supernet sit: `heads` and `hidden` are
    every model rank's head and MLP hidden-unit counts (`split_sizes`), `hd`
    the head width, `rank` this rank's place on the model axis."""

    rank: int
    heads: Tuple[int, ...]
    hidden: Tuple[int, ...]
    hd: int

    @property
    def size(self) -> int:
        return len(self.heads)

    def head_range(self, rank: Optional[int] = None) -> Tuple[int, int]:
        r = self.rank if rank is None else rank
        return sum(self.heads[:r]), sum(self.heads[:r + 1])

    def hidden_range(self, rank: Optional[int] = None) -> Tuple[int, int]:
        r = self.rank if rank is None else rank
        return sum(self.hidden[:r]), sum(self.hidden[:r + 1])

    def index(self, name: str, rank: Optional[int] = None
              ) -> Optional[Tuple[int, np.ndarray]]:
        """(dim, indices into the full tensor) of leaf `name`'s shard on
        `rank` (this one by default), None for a replicated leaf. Weights are
        (out, in): qkv rows of this rank's heads in each of q, k and v,
        proj columns of its heads, fc1 rows and fc2 columns of its hidden
        units; the qkv and fc1 biases as their rows."""
        kind = shard_kind(name)
        if kind is None:
            return None
        if kind in ("qkv", "proj"):
            h0, h1 = self.head_range(rank)
            seg = np.arange(h0 * self.hd, h1 * self.hd)
            if kind == "proj":
                return 1, seg
            width = sum(self.heads) * self.hd
            return 0, np.concatenate([k * width + seg for k in range(3)])
        m0, m1 = self.hidden_range(rank)
        return (0 if kind == "fc1" else 1), np.arange(m0, m1)


def shard_kind(name: str) -> Optional[str]:
    """'qkv' / 'proj' / 'fc1' / 'fc2' for a sharded leaf of a supernet (its
    name, or a name that ends in it: `mu.<name>`, an EMA key), else None.
    The proj and fc2 biases are replicated: they are added once, after the
    reduce."""
    for kind, leaves in (("qkv", ("attn.qkv.weight", "attn.qkv.bias")),
                         ("proj", ("attn.proj.weight",)),
                         ("fc1", ("mlp.fc1.weight", "mlp.fc1.bias")),
                         ("fc2", ("mlp.fc2.weight",))):
        if name.startswith("blocks.") or ".blocks." in name:
            if any(name.endswith(leaf) for leaf in leaves):
                return kind
    return None


def tp_layout(cfg, size: int, rank: int) -> TPLayout:
    """The layout of a uniform supernet (`cfg.num_heads` heads of `cfg.hd`,
    `cfg.hidden` MLP units) on a model axis of `size` ranks."""
    if cfg.block_overrides is not None:
        raise ValueError("tensor parallelism shards a uniform supernet; "
                         "this config has per-block widths")
    return TPLayout(rank=rank,
                    heads=split_sizes(cfg.num_heads, size, "heads"),
                    hidden=split_sizes(cfg.hidden, size, "MLP hidden units"),
                    hd=cfg.hd)


def tp_of(params) -> Optional[TPLayout]:
    """The layout of a sharded supernet, None for a whole one."""
    return getattr(params, "tp_layout", None)


def sharded_names(params, names) -> List[str]:
    """The names among `names` whose leaves `params` holds as shards."""
    if tp_of(params) is None:
        return []
    return [n for n in names if shard_kind(n) is not None]


def shard_tensor(name: str, full: torch.Tensor, layout: TPLayout,
                 rank: Optional[int] = None) -> torch.Tensor:
    """Rank `rank`'s shard of a full leaf (the leaf itself when
    replicated)."""
    at = layout.index(name, rank)
    if at is None:
        return full
    dim, idx = at
    return full.index_select(dim, torch.from_numpy(idx).to(full.device))


def unshard_tensor(name: str, pieces: List[torch.Tensor],
                   layout: TPLayout) -> torch.Tensor:
    """The full leaf from every model rank's shard, in rank order."""
    if layout.index(name, 0) is None:
        return pieces[0]
    dim = layout.index(name, 0)[0]
    shape = list(pieces[0].shape)
    shape[dim] = sum(p.shape[dim] for p in pieces)
    out = pieces[0].new_zeros(shape)
    for r, p in enumerate(pieces):
        idx = torch.from_numpy(layout.index(name, r)[1]).to(p.device)
        out.index_copy_(dim, idx, p)
    return out


def full_shape(name: str, shard_shape, layout: TPLayout) -> Tuple[int, ...]:
    """The shape of the full leaf whose shard on this rank has `shard_shape`
    (`shard_shape` itself for a replicated leaf)."""
    at = layout.index(name)
    shape = list(shard_shape)
    if at is not None:
        shape[at[0]] = sum(len(layout.index(name, r)[1])
                           for r in range(layout.size))
    return tuple(shape)


def gather_tensor(name: str, shard: torch.Tensor,
                  layout: TPLayout) -> torch.Tensor:
    """The full leaf from this rank's shard and its model group's: an
    all-reduce of a zero buffer each rank fills at its own indices (the
    rows come back exact, as in `distributed.gather_rows`)."""
    import torch.distributed as dist
    dim, idx = layout.index(name)
    out = shard.new_zeros(full_shape(name, shard.shape, layout))
    out.index_copy_(dim, torch.from_numpy(idx).to(shard.device),
                    shard.detach())
    dist.all_reduce(out, group=model_group())
    return out


def gather_named(tensors: Dict[str, torch.Tensor], layout: Optional[TPLayout]
                 ) -> Dict[str, torch.Tensor]:
    """{name: full tensor} of a {name: tensor} dict whose sharded leaves
    (by `shard_kind`) are this rank's shards; a collective of the model
    group, every rank calls it. The dict itself without a layout."""
    if layout is None:
        return tensors
    return {n: gather_tensor(n, t, layout) if shard_kind(n) else t
            for n, t in tensors.items()}


def shard_params(params, mesh, cfg=None):
    """Cut a replicated supernet into this rank's shards on `mesh`'s model
    axis, in place: the sharded leaves (`TPLayout.index`) become
    Parameters of their shards and `params.tp_layout` records the layout
    the forward reads. Returns `params`; unchanged on a model axis of one.
    `cfg` defaults to the supernet's own (`MimViT.cfg`). Raises
    ValueError when the model axis is larger than the head count."""
    cfg = cfg if cfg is not None else params.cfg
    size = mesh.size(mesh.mesh_dim_names.index("model"))
    if size == 1:
        return params
    if tp_of(params) is not None:
        raise ValueError("the supernet is sharded already")
    rank = mesh.get_local_rank("model")
    layout = tp_layout(cfg, size, rank)
    with torch.no_grad():
        for name, p in list(params.named_parameters()):
            if shard_kind(name) is None:
                continue
            path, leaf = name.rsplit(".", 1)
            setattr(params.get_submodule(path), leaf, torch.nn.Parameter(
                shard_tensor(name, p.detach(), layout).clone(),
                requires_grad=p.requires_grad))
    params.tp_layout = layout
    return params


def gather_params(params):
    """A whole copy of a sharded supernet (the full tensors put back from
    the model group's shards; a collective, every rank calls it), or
    `params` itself when it holds no shards. The sharded model is left as
    it is."""
    layout = tp_of(params)
    if layout is None:
        return params
    full = copy.deepcopy(params)
    del full.tp_layout
    with torch.no_grad():
        for name, p in list(full.named_parameters()):
            if shard_kind(name) is None:
                continue
            path, leaf = name.rsplit(".", 1)
            setattr(full.get_submodule(path), leaf, torch.nn.Parameter(
                gather_tensor(name, p, layout),
                requires_grad=p.requires_grad))
    return full
