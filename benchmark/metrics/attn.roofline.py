"""The attention kernels' share of their roofline, in %: the sum of the
bounds of the attention calls the traced step calls made (one forward and
one backward a block and microbatch, at the configuration's unpadded
shapes: `flops.attention_bound_s`) over the attention kernels' summed
device time. Nothing when no attention kernel ran."""

from benchmark.flops import attention_bound_s, attention_calls


def read(t):
    s = t.device_s("attention")
    if s <= 0 or not t.calls:
        return None
    c = t.cell
    per_micro = sum(sum(attention_bound_s(call))
                    for call in attention_calls(c["config"], c["rank_rows"]))
    bound = per_micro * c["microbatches_per_call"] * t.calls
    return 100.0 * bound / s
