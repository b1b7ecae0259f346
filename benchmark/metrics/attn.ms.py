"""Device milliseconds a step call in the port's attention kernels
(`attention_*`: forward and backward, any body)."""


def read(t):
    s = t.device_s("attention")
    return s / t.calls * 1e3 if s > 0 and t.calls else None
