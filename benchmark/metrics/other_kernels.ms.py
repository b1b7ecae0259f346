"""Device milliseconds a step call in every kernel that is not a GEMM, an
attention or an NCCL kernel: layer-norm islands, gates, PMIM, the losses,
the fused augment, Mixup, the optimizer (memcpys and memsets left out)."""


def read(t):
    s = t.device_s("other")
    return s / t.calls * 1e3 if s > 0 and t.calls else None
