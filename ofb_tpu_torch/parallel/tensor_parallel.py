"""The two collectives of the tensor-parallel supernet, as autograd
functions on the model axis of the active mesh.

The JAX package gets tensor parallelism from XLA: with the block matmuls
placed by `param_sharding_rules(tensor_parallel=True)` the SPMD partitioner
inserts the all-reduces. The port writes them where Megatron-LM does:

  * `copy_to_model(x)`: the identity forward; the backward sums the
    gradient over the model group. It sits where a replicated tensor
    enters a sharded product (the tokens into qkv and fc1, the replicated
    gates before each rank takes its heads' or hidden units' slice), so
    that a replicated leaf upstream gets the gradient of every rank's part;
  * `reduce_from_model(y)`: the forward sums the ranks' partial products
    (proj and fc2 over their column shards); the backward is the identity.

Both sum in fp32 and cast back: a sum of bf16 partials rounds each
partial's sum once more than the one-process GEMM does. Without a model
axis of more than one rank both are the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .distributed import model_group, model_rank_world


def _sum_fp32(t: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of `t`, computed in fp32, in t's
    dtype."""
    buf = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(buf, group=model_group())
    return buf.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return _sum_fp32(y)

    @staticmethod
    def backward(ctx, g):
        return g


def model_parallel() -> bool:
    """Whether a model axis of more than one rank is active."""
    return model_rank_world()[1] > 1


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """x forward; its gradient summed over the model group backward."""
    return _CopyToModel.apply(x) if model_parallel() else x


def reduce_from_model(y: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of the ranks' partials y (in fp32)
    forward; the gradient as it is backward."""
    return _ReduceFromModel.apply(y) if model_parallel() else y


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of a tensor with no gradient (square
    sums of sharded gradients); `t` on a model axis of one."""
    return _sum_fp32(t) if model_parallel() else t
