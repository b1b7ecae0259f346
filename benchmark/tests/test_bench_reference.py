"""The plain reference against the program's step on the CPU at a tiny
width: in fp32 the two take the same three updates (the same draws, the
same arithmetic); in the program's bf16 a whole run of the harness comes
out correct; a data-parallel step of two ranks is the reference's step
over the global batch."""

import json

import pytest
import torch

from benchmark import cells, compare, program
from benchmark import run as R
from benchmark.reference import steps as ref_steps
from tiny import TinyCell


def _reading(cell, seed, dtype, rank=0):
    prog = cells.phase(cell.phase).build(
        cell.config, cell.workload, seed, torch.device("cpu"), rank,
        compute_dtype=dtype)
    return program.first_updates(prog, seed)


@pytest.mark.parametrize("phase, A", [("search", 2), ("finetune", 1)])
def test_the_program_in_fp32_takes_the_references_updates(phase, A):
    cell = TinyCell(phase, A=A)
    seed = 2 ** 31 + 11
    got = compare.gaps(_reading(cell, seed, torch.float32),
                       ref_steps.run(phase, cell.config, cell.workload, seed,
                                     torch.device("cpu")))
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-5
    assert got["change_gap"] < 1e-4


@pytest.mark.parametrize("phase, A", [("search", 2), ("finetune", 1)])
def test_a_run_of_the_harness_on_the_cpu_is_correct(phase, A):
    out = R.run_rank(TinyCell(phase, A=A), 7, 0.2, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["foreign"] == []


def _rank(rank, port, q):
    import torch
    torch.set_num_threads(1)
    out = R.run_rank(TinyCell("search", chips=2, A=1), 5, 0.2, False,
                     rank=rank, world=2, device="cpu", port=port)
    q.put((rank, json.dumps({k: out.get(k) for k in ("correct", "checks",
                                                     "attempted")})))


def test_two_ranks_take_the_references_global_step(monkeypatch):
    import torch.multiprocessing as mp
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = R._free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    got = dict(q.get(timeout=600) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    r0 = json.loads(got[0])
    assert r0["correct"], r0["checks"]
