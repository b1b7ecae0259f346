"""The step's share of the card's dense bf16 peak, in %: the FLOPs the
traced calls computed (`flops.train_flops_per_image` times this rank's
images) over the traced window's length, against `peaks.H100`. The card's
power limit is printed beside it by the harness."""

from benchmark.flops import train_flops_per_image
from benchmark.peaks import H100


def read(t):
    c = t.cell
    if not t.calls or t.window_s <= 0:
        return None
    flops = train_flops_per_image(c["config"], c["phase"]) \
        * c["rank_images_per_call"] * t.calls
    return 100.0 * flops / t.window_s / H100.bf16_flops
