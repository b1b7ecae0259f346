"""A tiny cell of each phase for the CPU tests: the real cells' files with
the widths, images and batches cut to what a test run holds."""

from __future__ import annotations

import copy

from benchmark import cells


# The comparison's limits at this size, set as a cell's are (PERF.md, §6)
# from CPU readings of the tiny cells: the program in bf16
# on seeds 1-6 (search: grad 0.0020-0.0047, change 0.044-0.099; finetune:
# loss 6.1e-5-1.5e-4, grad 0.0011-0.0034, change 0.038-0.087) against the
# control on seeds 7-9 (search: grad 0.027-0.041, change 0.17-0.22;
# finetune: loss 0.0013-0.0016, grad 0.029-0.075, change 0.12-0.26) and
# half the batch (search: grad 0.64-1.49; finetune: loss 0.016-0.035,
# grad 0.32-0.78).
TINY_LIMITS = {
    "search": {"loss_gap": 1e-4, "grad_gap": 0.012, "change_gap": 0.14},
    "finetune": {"loss_gap": 4e-4, "grad_gap": 0.01, "change_gap": 0.16},
}


class TinyCell:
    """A cell object as `benchmark.run.Cell` makes one, at a tiny size:
    the DeiT-Ti supernet's registry entry at 32 px (4 patches) for the
    search, a two-block subnet with its own heads, head dims 8 and 16
    and MLP widths a block (as an OFB export writes them) for the finetune."""

    def __init__(self, phase: str = "search", chips: int = 1, A: int = 2):
        self.phase, self.chips = phase, chips
        self.name = f"tiny.{phase}"
        self.bench = cells.benchmark()
        real = {"search": "deit_s.search",
                "finetune": "deit_ti.finetune"}[phase]
        wl = copy.deepcopy(cells.workload(real))
        if phase == "search":
            self.config = dict(cells.config("deit_s_ofb"),
                               model="deit_tiny_patch16_224_mim",
                               img_size=32, num_classes=10, embed_dim=192,
                               num_heads=3)
        else:
            self.config = dict(cells.config("deit_ti"), img_size=32,
                               num_classes=10, embed_dim=36, depth=2,
                               block_overrides=[[2, 8, 24], [1, 16, 40]])
        wl.update(chips=chips, microbatch=4, accum_iter=A,
                  dataset_images=4000, staging=40, cache_images=16,
                  trace_calls=3, limits=dict(TINY_LIMITS[phase]))
        self.workload = wl
