"""Process group set-up, barriers and the collectives of data parallelism.

Port of ofb_tpu/parallel/distributed.py onto torch.distributed, one process
per card:

  * `init_distributed()` joins the process group that the launcher
    describes (torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR /
    MASTER_PORT, or the JAX package's COORDINATOR_ADDRESS / NUM_PROCESSES
    / PROCESS_ID) and returns (rank, world); without either it joins none
    and returns (0, 1). NCCL on the card, gloo on the CPU.
  * `barrier_sync(name)` fences the ranks (a checkpoint a peer reads next).
  * `reinit_state(tree)`, the analog of `reinit_mesh`: every tensor of a
    state tree from rank 0, so a resume on another world size starts
    replicated.

The steps, the compress pass and the evaluation use the collectives below
whenever a process group is up; without one they are the identity. Every
collective packs its tensors into one flat buffer per dtype, so a step
costs one all-reduce, not one a leaf. Each takes an optional `group`, a
subgroup of the world; `data_group()` and `model_group()` give the two
axes of the active (data, model) mesh (`parallel.mesh.make_mesh`), and
the whole world while no mesh is active, so a data-parallel run without a
mesh is what it was.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device


def group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_world() -> Tuple[int, int]:
    """(rank, world) of the process group, (0, 1) without one."""
    if not group_active():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


# the active (data, model) DeviceMesh and the default group it was made in:
# a mesh of a group since destroyed is not active
_MESH: List = []


def set_active_mesh(mesh) -> None:
    """Make `mesh` (a DeviceMesh with 'data' and 'model' axes, or None) the
    one whose axes `data_group()` / `model_group()` give."""
    _MESH[:] = [] if mesh is None else [(mesh, dist.group.WORLD)]


def active_mesh():
    """The active mesh, or None (none set, or its process group is gone)."""
    if not _MESH or not group_active():
        return None
    mesh, world = _MESH[0]
    return mesh if world is dist.group.WORLD else None


def _axis(name: str):
    mesh = active_mesh()
    return None if mesh is None else mesh.get_group(name)


def data_group():
    """The process group of this rank's 'data' axis of the active mesh (the
    ranks that hold other rows of the batch), the world without a mesh."""
    return _axis("data")


def model_group():
    """The process group of this rank's 'model' axis of the active mesh
    (the ranks that hold other shards of the same rows), the world without
    a mesh."""
    return _axis("model")


def group_rank_size(group=None) -> Tuple[int, int]:
    """(this rank's place in `group`, its size); the world's for None, (0, 1)
    without a process group."""
    if not group_active():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def data_rank_world() -> Tuple[int, int]:
    """(rank, size) on the data axis: the rows this rank holds of a global
    batch, and into how many parts the batch splits."""
    return group_rank_size(data_group())


def model_rank_world() -> Tuple[int, int]:
    """(rank, size) on the model axis; (0, 1) without a mesh."""
    if active_mesh() is None:
        return 0, 1
    return group_rank_size(model_group())


def local_rank() -> int:
    """The card of this process on its host: LOCAL_RANK (torchrun), else
    0."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def _launch_env() -> Optional[Tuple[int, int, str]]:
    """(rank, world, init method) from the launcher's environment, or None
    when no launcher set one."""
    env = os.environ
    if "WORLD_SIZE" in env:
        return int(env.get("RANK", "0")), int(env["WORLD_SIZE"]), "env://"
    coord = env.get("COORDINATOR_ADDRESS")
    if coord:
        return (int(env.get("PROCESS_ID", "0")),
                int(env.get("NUM_PROCESSES", "1")), f"tcp://{coord}")
    return None


def init_distributed(backend: Optional[str] = None, *, device="cuda",
                     init_method: Optional[str] = None,
                     timeout: Optional[float] = None) -> Tuple[int, int]:
    """Join the process group the environment describes; returns (rank,
    world). An existing group is kept. Without a launcher's environment no
    group is joined and (0, 1) comes back, as the JAX package's call is a
    no-op on one host. `backend` defaults to NCCL on `device` "cuda" and
    gloo on "cpu"; on the card this process takes cuda:LOCAL_RANK.
    `init_method` (e.g. a `file://` path) replaces the environment's
    rendezvous, whose rank and world it still reads. `timeout` (seconds)
    bounds the rendezvous and every collective's wait for a peer, after
    which they raise (torch's default without it)."""
    if group_active():
        return rank_world()
    launch = _launch_env()
    if launch is None:
        return 0, 1
    rank, world, method = launch
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank())
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or method, rank=rank, world_size=world, **kw)
    return rank, world


def barrier_sync(name: str = "ofb_barrier") -> None:
    """Fence every rank (a no-op at world 1 and without a group). `name`
    says what the fence waits for."""
    del name
    if group_active() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def collective_device() -> torch.device:
    """Where a collective's buffer lives: the current card under NCCL,
    the CPU under gloo."""
    if group_active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _buckets(tensors: Sequence[torch.Tensor]) -> Dict[Tuple, List[int]]:
    """Indices of `tensors` by (dtype, device): one flat buffer each."""
    out: Dict[Tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.dtype, t.device), []).append(i)
    return out


def _flat_apply(tensors: Sequence[torch.Tensor], op) -> None:
    """op(flat buffer) for each dtype's flat copy of `tensors`, then the
    result copied back into each tensor in place (one fused copy). Bools
    travel as uint8."""
    with torch.no_grad():
        for (dtype, _), idx in _buckets(tensors).items():
            dst = [tensors[i] for i in idx]
            flat = torch.cat([t.detach().reshape(-1) for t in dst])
            if dtype == torch.bool:
                flat = flat.to(torch.uint8)
            op(flat)
            flat = flat.to(dtype)
            parts = flat.split([t.numel() for t in dst])
            torch._foreach_copy_(dst, [v.view(t.shape)
                                       for v, t in zip(parts, dst)])


def all_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average every tensor over the ranks of `group` (the world for
    None), in place (floating point)."""
    if not group_active() or not tensors:
        return
    world = dist.get_world_size(group)

    def op(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(world)

    _flat_apply(tensors, op)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               group=None) -> None:
    """Every tensor takes the values of `group`'s rank `src` (a global
    rank), in place."""
    if not group_active() or not tensors:
        return
    _flat_apply(tensors,
                lambda flat: dist.broadcast(flat, src, group=group))


def all_sum(values: Sequence[float], group=None) -> List[float]:
    """The sum over the ranks of `group` of a few host numbers, in
    float64."""
    if not group_active():
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=collective_device())
    dist.all_reduce(t, group=group)
    return t.cpu().tolist()


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The rows of `x` (dim 0) of every rank of `group`, in rank order: one
    all-reduce of a zero buffer each rank fills at its place, which every
    backend takes for card tensors (gloo gathers only host ones) and which
    adds only zeros, so the rows come back exact."""
    rank, world = group_rank_size(group)
    if world == 1:
        return x
    mb = x.shape[0]
    out = x.new_zeros((world * mb,) + tuple(x.shape[1:]))
    out[rank * mb:(rank + 1) * mb] = x
    dist.all_reduce(out, group=group)
    return out


def reinit_state(tree):
    """Every tensor of a state tree (modules, dicts, sequences,
    dataclasses) takes rank 0's values, in place; returns the tree."""
    from .mesh import replicate
    return replicate(tree)
