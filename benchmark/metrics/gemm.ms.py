"""Device milliseconds a step call in GEMM kernels (cuBLAS and cuDNN matrix
products, matched by name: `trace.kernel_class`)."""


def read(t):
    s = t.device_s("gemm")
    return s / t.calls * 1e3 if s > 0 and t.calls else None
