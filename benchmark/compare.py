"""The comparison that decides `correct`: the program's first `UPDATES`
updates, as the window's own call made them, against the plain reference's
(`reference.steps.run`), the same count on both sides.

Three numbers, each the worst of its kind:

  loss_gap    the largest relative gap between the program's and the
              reference's loss over the updates;
  grad_gap    over the leaves, the gap between the norms of the program's
              and the reference's first gradient, as each optimizer got it
              (the first moment after one update over (1 - b1)), over the
              reference's norm of that leaf or of the median leaf,
              whichever is larger;
  change_gap  the same of each leaf's change after the updates
              (the finetune's EMA weights too), over the leaves whose
              reference gradient is at least a thousandth of the median
              leaf's: a leaf with no gradient moves by weight decay and
              round-off alone.

Each is held to the cell's limit (`limits` in its workload file); a number
the cell gives no limit is not compared (one that separates no fault from
sound runs: PERF.md, §6). A number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

UPDATES = 3                   # compared, from the first
ZERO_GRADIENT = 1e-3          # of the median leaf's reference gradient


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    names = list(names)
    if not names:
        return float("nan")
    floor = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
               for n in names)


def counted_leaves(ref_grad: Dict[str, float], names) -> List[str]:
    """The leaves (and their `ema.` twins) whose reference gradient is at
    least a thousandth of the median leaf's."""
    floor = ZERO_GRADIENT * statistics.median(ref_grad.values())
    return [n for n in names
            if ref_grad[n[4:] if n.startswith("ema.") else n] >= floor]


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """{loss_gap, grad_gap, change_gap} of two readings, each a dict with
    `loss` (a list), `grad` and `change` ({leaf: norm})."""
    if sorted(prog["grad"]) != sorted(ref["grad"]) \
            or sorted(prog["change"]) != sorted(ref["change"]):
        raise ValueError("the program's leaves are not the reference's")
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = float("nan")
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap(prog["grad"], ref["grad"], ref["grad"]),
            "change_gap": _leaf_gap(prog["change"], ref["change"],
                                    counted_leaves(ref["grad"],
                                                   ref["change"]))}


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) of the numbers with a limit."""
    checks = {k: {"value": values[k], "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
