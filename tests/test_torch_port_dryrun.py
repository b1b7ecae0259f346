"""`python -m ofb_tpu_torch.dryrun`, the port's counterpart of
`__graft_entry__.dryrun_multichip`, as tests/test_parallel.py runs the
JAX one from a process without enough devices: run from a fresh
process without a launcher with --device cpu, it starts its ranks itself
(gloo on the CPU),
runs the tiny supernet's sharded search step, the forced compress event
and the post-prune step, prints the compress digest line and exits 0.
At 4 devices the mesh is (2 x 2), at 2 it is (2 x 1), the JAX mesh
choice."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("devices,mesh", [(4, "2x2"), (2, "2x1")])
def test_dryrun_starts_its_ranks_itself(devices, mesh):
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
        "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    res = subprocess.run(
        [sys.executable, "-m", "ofb_tpu_torch.dryrun", "--devices",
         str(devices), "--tiny", "--device", "cpu"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
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
