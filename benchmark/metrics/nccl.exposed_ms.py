"""Milliseconds a step call in which an NCCL kernel runs on the card and no
other kernel does (the all-reduce's time not hidden behind compute), the
largest over the ranks. Nothing without NCCL kernels."""

from benchmark.trace import length, subtract

COMBINE = "max"


def read(t):
    nccl = t.intervals("nccl")
    if not nccl or not t.calls:
        return None
    rest = t.intervals("gemm", "attention", "other")
    return length(subtract(nccl, rest)) * 1e-6 / t.calls * 1e3
