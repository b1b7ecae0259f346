"""Run logging: the JSON-lines log.txt / alpha.txt writers, score-map dumps
and the main-process print.

Port of ofb_tpu/utils/logging.py, with the same files, keys and nesting, so
`scripts/prune_timeline.py`, `scripts/run_status.py` and
`scripts/frontier.py` read the port's runs unchanged. Under a process
group (`parallel/`) rank 0 alone prints and writes.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


def is_main_process() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def master_print(*args, **kwargs):
    if is_main_process():
        kwargs.setdefault("flush", True)
        print(*args, **kwargs)


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class RunLogger:
    def __init__(self, output_dir: str):
        self.dir = output_dir
        if is_main_process() and output_dir:
            os.makedirs(output_dir, exist_ok=True)

    def append_jsonl(self, filename: str, record: Dict[str, Any]):
        if not (is_main_process() and self.dir):
            return
        with open(os.path.join(self.dir, filename), "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_epoch(self, epoch: int, train_stats: Dict[str, float],
                  test_stats: Dict[str, float], n_parameters: int,
                  n_gflops: float):
        self.append_jsonl("log.txt", {
            **{f"train_{k}": v for k, v in train_stats.items()},
            **{f"soft_test_{k}": v for k, v in test_stats.items()},
            "epoch": epoch,
            "n_parameters": int(n_parameters),
            "n_gflops": float(n_gflops),
        })

    def log_alphas(self, epoch: int, alphas) -> None:
        """alpha.txt JSON lines: every alpha of an `Alphas` module, grouped
        by dimension family."""
        rec = {
            "epoch": epoch,
            "attn": [_host(b.attn).reshape(-1).tolist()
                     for b in alphas.blocks],
            "mlp": [_host(b.mlp).reshape(-1).tolist() for b in alphas.blocks],
            "patch": _host(alphas.patch).reshape(-1).tolist(),
            "embed": [_host(alphas.embed).reshape(-1).tolist()],
        }
        self.append_jsonl("alpha.txt", rec)

    def save_score_maps(self, params, alphas, arch, space) -> None:
        """saliency / sparsity / joint .npy dumps per searchable module:
        saliency = sorted sigmoid(score), sparsity = the sorted-domain
        weighted mask, joint = (1 - w_p) * mask + w_p * saliency. Appended
        across epochs; an unchanged snapshot is not added again."""
        if not (is_main_process() and self.dir):
            return
        from ..ops.gates import weighted_mask_1d, weighted_mask_attn

        maps = {}
        for name in ("saliency", "sparsity", "joint"):
            p = os.path.join(self.dir, name + ".npy")
            maps[name] = (np.load(p, allow_pickle=True).item()
                          if os.path.exists(p) else {})

        def add(idx, score, wm, w_p):
            s = 1.0 / (1.0 + np.exp(-_host(score).astype(np.float64)))
            s_sorted = np.sort(s, axis=-1)[..., ::-1]
            if s_sorted.ndim == 2 and s_sorted.shape[0] > 1:
                s_sorted = s_sorted[np.argsort(s_sorted.sum(-1))[::-1]]
            m = _host(wm).astype(np.float64)
            w_p = float(w_p)
            for name, val in (("saliency", s_sorted), ("sparsity", m),
                              ("joint", (1 - w_p) * m + w_p * s_sorted)):
                hist = maps[name].setdefault(idx, [])
                if hist and hist[-1].shape == val.shape and \
                        np.array_equal(hist[-1], val):
                    continue
                hist.append(val)

        def bank(a, like):
            return torch.from_numpy(a).to(like.device)

        with torch.no_grad():
            add(0, params.patch_embed.score,
                weighted_mask_1d(alphas.embed, arch.embed.switch,
                                 bank(space.embed.mask_bank, alphas.embed)),
                arch.embed.w_p)
            for i, bs in enumerate(space.blocks):
                blk, al, ar = params.blocks[i], alphas.blocks[i], \
                    arch.blocks[i]
                add(2 * i + 1, blk.attn.score,
                    weighted_mask_attn(al.attn, ar.attn.switch,
                                       bank(bs.attn.mask_bank, al.attn)),
                    ar.attn.w_p)
                add(2 * i + 2, blk.mlp.score,
                    weighted_mask_1d(al.mlp, ar.mlp.switch,
                                     bank(bs.mlp.mask_bank, al.mlp)),
                    ar.mlp.w_p)

        for name, d in maps.items():
            np.save(os.path.join(self.dir, name + ".npy"), d)  # type: ignore
