"""A run with the timed path broken underneath comes out not correct, at a
size a test run holds: the harness's look for a card skipped, the rest of
a run driven, each fault a training cell can have planted in the program's
step (`benchmark.control.planted`); and the control, the reference with
float8 products, fails the limits (at this size, `tiny.TINY_LIMITS`)."""

import json

import pytest
import torch

from benchmark import compare
from benchmark import run as R
from benchmark.control import planted
from benchmark.reference import steps as ref_steps
from tiny import TinyCell

CELLS = [("search", 2), ("finetune", 1)]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("phase, A", CELLS)
def test_a_broken_step_is_not_correct(fault, phase, A):
    cell = TinyCell(phase, A=A)
    with planted(fault):
        out = R.run_rank(cell, 13, 0.2, False, device="cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("phase, A, chips", [("search", 2, 1),
                                             ("finetune", 1, 1),
                                             ("search", 1, 2)])
def test_the_control_fails_the_limits(phase, A, chips):
    cell = TinyCell(phase, chips=chips, A=A)
    dev = torch.device("cpu")
    ref = ref_steps.run(phase, cell.config, cell.workload, 17, dev)
    ctl = ref_steps.run(phase, cell.config, cell.workload, 17, dev,
                        control=True)
    ok, checks = compare.judge(compare.gaps(ctl, ref),
                               cell.workload["limits"])
    assert not ok, checks


def _rank(rank, port, fault, q):
    torch.set_num_threads(1)
    cell = TinyCell("search", chips=2, A=1)
    with planted(fault):
        out = R.run_rank(cell, 19, 0.2, False, rank=rank, world=2,
                         device="cpu", port=port)
    q.put((rank, json.dumps({k: out.get(k) for k in ("correct", "checks")})))


def test_two_ranks_without_their_exchange_are_not_correct(monkeypatch):
    import torch.multiprocessing as mp
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = R._free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, "unexchanged", q))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(q.get(timeout=600) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    r0 = json.loads(got[0])
    assert r0["correct"] is False, r0["checks"]
