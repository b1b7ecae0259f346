"""Device mesh, batch rows and parameter placements.

Port of ofb_tpu/parallel/mesh.py. The reference's only parallelism is DDP
over NCCL: a 1-D 'data' axis, the batch split over it and the state
replicated, the gradients averaged by an all-reduce (which the port's
steps make, `core/steps.py:_accumulate`). A second 'model' axis names the
tensor-parallel placement of the wide matmuls; its rules are here, a step
that uses them is not.

  * `make_mesh` — a `DeviceMesh` over the world, (world, 1) by default;
  * `local_rows` — this rank's rows of a global batch, the order in which
    `jax.make_array_from_process_local_data` assembles the global batch
    from each process's rows (`batch_sharding` / `shard_batch`);
  * `replicate` — every tensor of a tree from rank 0;
  * `param_sharding_rules` — leaf name -> `Replicate()` / `Shard(dim)` in
    the port's (out, in) weight layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .distributed import (broadcast_, collective_device, group_active,
                          rank_world)


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
    return init_device_mesh(collective_device().type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


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
    """This rank's rows (`local_rows`) of a global-batch tensor, or of each
    tensor field of a NamedTuple of them (None fields kept); `x` itself at
    world 1."""
    rank, world = rank_world()
    if world == 1 or x is None:
        return x
    if isinstance(x, tuple):
        return type(x)(*(this_rank_rows(f, dim) for f in x))
    return local_rows(x, rank, world, dim)


def draw_rows(draw, batch: int):
    """This rank's `batch` rows of `draw(batch * world)`, a random draw with
    one leading row per image (a tensor or a NamedTuple of them). Every
    rank draws over the global batch from a generator in the same state,
    so a world of N draws what one process draws for the whole batch."""
    _, world = rank_world()
    return this_rank_rows(draw(batch * world))
