"""`python -m ofb_tpu_torch.dryrun`, the port's counterpart of
`__graft_entry__.dryrun_multichip`, as tests/test_parallel.py runs the
JAX one from a process without enough devices: run from a fresh
process without a launcher with --device cpu, it starts its ranks itself
(gloo on the CPU),
runs the tiny supernet's sharded search step, the forced compress event
and the post-prune step, prints the compress digest line and exits 0.
At 4 devices the mesh is (2 x 2), at 2 it is (2 x 1), the JAX mesh
choice. Beside it, `dryrun.run_ranks`, which waits for those ranks: a rank
that fails ends its peers at once and is named with its exit code and
stderr, a rank that fills its stderr pipe blocks no one, a rank that hangs
is ended at the timeout."""

import os
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dryrun(*args):
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
        "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    return subprocess.run(
        [sys.executable, "-m", "ofb_tpu_torch.dryrun", "--tiny", "--device",
         "cpu", *args], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=600)


def _why(res):
    """The dry run's account of a failure: every rank's exit code and the
    stderr of each rank that failed (`run_ranks`), else its stderr's
    tail."""
    at = res.stderr.find("dryrun: exit codes by rank")
    return res.stderr[at:] if at >= 0 else res.stderr[-3000:]


@pytest.mark.parametrize("devices,mesh", [(4, "2x2"), (2, "2x1")])
def test_dryrun_starts_its_ranks_itself(devices, mesh):
    res = _dryrun("--devices", str(devices))
    assert res.returncode == 0, _why(res)
    out = res.stdout
    assert f"tiny: mesh=({mesh}) float32 step0 loss_total=" in out, out
    assert "compress digest: block0.mlp: prune event" in out, out
    assert "mlp-switch sha256[:12]=" in out, out
    done = [ln for ln in out.splitlines() if ln.startswith(
        f"dryrun_multichip({devices}): tiny mesh=({mesh}) post-prune "
        "loss_total=")]
    assert len(done) == 1 and done[0].endswith(" OK"), out
    # every rank reported its step times
    assert sum(ln.startswith("rank ") for ln in out.splitlines()) == devices


def test_dryrun_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without --device the ranks go to the card: with none, the dry run
    raises before it starts a rank instead of running on the CPU."""
    from ofb_tpu_torch import dryrun
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "PROCESS_ID", "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "_spawn", lambda *a: pytest.fail(
        "a rank was started without a card"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--devices", "2", "--tiny"])


def test_a_failing_rank_is_named_and_ends_the_run():
    """A mesh that does not fit the world fails every rank after the
    rendezvous: the dry run exits with their code in seconds (not
    dryrun.TIMEOUT) and names a failed rank, its code and its stderr."""
    from ofb_tpu_torch import dryrun
    t0 = time.perf_counter()
    res = _dryrun("--devices", "4", "--mesh", "3", "1")
    assert res.returncode == 2, _why(res)
    assert time.perf_counter() - t0 < dryrun.TIMEOUT / 4
    why = _why(res)
    assert why.startswith("dryrun: exit codes by rank [") and \
        "failed with exit code 2; its stderr's last lines:\n" in why, why
    assert "--mesh [3, 1] in a world of 4" in why, why
    assert "[rank 0] " in res.stderr and "[rank 3] " in res.stderr


def _ranks(scripts, timeout):
    from ofb_tpu_torch import dryrun
    n = len(scripts)
    t0 = time.perf_counter()
    code = dryrun.run_ranks([[sys.executable, "-c", s] for s in scripts],
                            [dict(os.environ, RANK=str(r)) for r in range(n)],
                            REPO, timeout=timeout)
    return code, time.perf_counter() - t0


# a rank that waits for `path` (as a peer waits in a collective), at most a
# minute
WAIT = ("import os, sys, time\nt = time.time()\n"
        "while not os.path.exists({path!r}):\n"
        "    assert time.time() - t < 60, 'no peer'\n    time.sleep(0.05)\n")


def test_a_failing_rank_ends_its_peers(capsys):
    """Rank 1 exits 3; its peers would wait on it for ten minutes: they
    are killed at once, and rank 1 is named with its code and stderr."""
    hang = "import time; time.sleep(600)"
    code, took = _ranks([hang, "import sys; sys.stderr.write('boom\\n'); "
                         "sys.exit(3)", hang, hang], timeout=600)
    err = capsys.readouterr().err
    assert code == 3 and took < 60, (code, took, err)
    assert "[rank 1] boom" in err
    assert "dryrun: exit codes by rank [-9, 3, -9, -9] (ranks [0, 2, 3] " \
        "killed: rank 1 failed)" in err, err
    assert "dryrun: rank 1 failed with exit code 3; its stderr's last " \
        "lines:\nboom" in err, err


def test_a_full_stderr_pipe_blocks_no_rank(tmp_path, capsys):
    """Rank 2 writes 256 KiB to stderr (four pipe buffers) before it lets
    its peers go on; ranks 0, 1 and 3 wait for it. Read one rank after the
    other, rank 2 would block on its pipe and rank 0 wait for ever; drained
    at once, all exit 0 and rank 2's stderr arrives whole."""
    flag = str(tmp_path / "flag")
    waiter = WAIT.format(path=flag) + "print('done', flush=True)\n"
    writer = ("import sys\nfor i in range(4096):\n"
              "    sys.stderr.write('x' * 63 + '\\n')\n"
              "sys.stderr.flush()\n"
              f"open({flag!r}, 'w').close()\n")
    code, took = _ranks([waiter, waiter, writer, waiter], timeout=120)
    out, err = capsys.readouterr()
    assert code == 0 and took < 120, (code, took, err[-2000:])
    assert out == "done\n" * 3
    assert err.count("[rank 2] " + "x" * 63 + "\n") == 4096


def test_a_rank_that_hangs_ends_at_the_timeout(capsys):
    code, took = _ranks(["pass", "import time; time.sleep(600)"], timeout=2)
    err = capsys.readouterr().err
    assert code == 124 and took < 30, (code, took)
    assert "dryrun: exit codes by rank [0, -9] (ranks [1] killed: still " \
        "running after 2 s)" in err, err


def test_a_rank_whose_peer_never_comes_raises_at_its_timeout(tmp_path):
    """`init_distributed(timeout=)`, which the dry run's spawned ranks take
    (`dryrun.PEER_TIMEOUT`): rank 0 of a world of 2 whose peer never joins
    raises after the timeout instead of waiting torch's default, so a rank
    stuck before a collective ends its peers' wait and is named."""
    from ofb_tpu_torch import dryrun
    assert dryrun.PEER_TIMEOUT < dryrun.TIMEOUT / 2
    env = dict(os.environ, RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
               GLOO_SOCKET_IFNAME="lo")
    for k in ("MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS"):
        env.pop(k, None)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c",
         "from ofb_tpu_torch.parallel.distributed import init_distributed\n"
         f"init_distributed(device='cpu', init_method="
         f"'file://{tmp_path / 'rdzv'}', timeout=2)\n"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and time.perf_counter() - t0 < 120
    assert "timeout" in res.stderr.lower(), res.stderr[-2000:]
