"""The port's data-parallel pieces (ofb_tpu_torch/parallel/, the package's
`create_model` / `list_models`, utils/profiling.py) in one process on the
CPU, against ofb_tpu where it has the same function:

* `init_distributed()` without a launcher's environment joins no group and
  returns (0, 1); `barrier_sync` and every collective are the identity
  there and in a gloo world of one (a `file://` rendezvous under tmp_path);
* `param_sharding_rules`, leaf by leaf, the placement of
  `ofb_tpu.parallel.mesh.param_sharding_rules` on the same tiny supernet,
  its (in, out) kernels mapped to the port's (out, in) weights, with
  tensor parallelism on and off;
* `local_rows`: rank r's rows are the shard that the JAX package's
  `batch_sharding` puts on mesh position r (the rows
  `make_array_from_process_local_data` takes from process r), plain and
  with the accumulation axis leading;
* `trace` writes a Chrome trace, `create_model` / `list_models` are the
  registry's.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import ofb_tpu_torch
from ofb_tpu.parallel import mesh as jmesh
from ofb_tpu_torch.core.steps import named_tensors
from ofb_tpu_torch.data.pipeline import epoch_plan
from ofb_tpu_torch.device import resolve_device
from ofb_tpu_torch.models import registry as R
from ofb_tpu_torch.models.from_jax import torch_name
from ofb_tpu_torch.parallel import distributed as D
from ofb_tpu_torch.parallel import mesh as M
from ofb_tpu_torch.utils.profiling import trace
from test_torch_port_from_jax import TINY, jax_supernet, port_supernet

torch.set_num_threads(1)
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "PROCESS_ID")


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def world_of_one(tmp_path, monkeypatch):
    """A gloo process group of one rank, torn down after the test."""
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not D.group_active()
    rank_world = D.init_distributed(
        device="cpu", init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        yield rank_world
    finally:
        dist.destroy_process_group()


def test_init_distributed_without_a_launcher_joins_no_group(no_launcher):
    assert D.init_distributed(device="cpu") == (0, 1)
    assert not D.group_active()
    assert D.rank_world() == (0, 1)
    D.barrier_sync("nothing to wait for")
    assert resolve_device("cpu") == torch.device("cpu")


def test_collectives_are_the_identity_without_a_group(no_launcher):
    g = torch.Generator().manual_seed(0)
    t = [torch.randn(3, 4, generator=g), torch.randn(5, generator=g)]
    before = [x.clone() for x in t]
    D.all_mean_(t)
    D.broadcast_(t)
    assert all(torch.equal(a, b) for a, b in zip(t, before))
    assert D.all_sum([1.5, 2.0]) == [1.5, 2.0]
    assert D.gather_rows(t[0]) is t[0]
    assert M.this_rank_rows(t[0]) is t[0]
    drawn = M.draw_rows(lambda n: torch.rand(
        (n, 2), generator=torch.Generator().manual_seed(3)), 4)
    assert torch.equal(drawn, torch.rand(
        (4, 2), generator=torch.Generator().manual_seed(3)))
    with pytest.raises(RuntimeError, match="process group"):
        M.make_mesh()


def test_world_of_one_over_gloo(world_of_one):
    assert world_of_one == (0, 1)
    assert D.group_active() and dist.get_backend() == "gloo"
    # a second call keeps the group
    assert D.init_distributed(device="cpu") == (0, 1)
    D.barrier_sync("one rank")
    g = torch.Generator().manual_seed(1)
    t = [torch.randn(6, generator=g), torch.randn(2, 3, generator=g),
         torch.arange(4), torch.tensor([True, False])]
    before = [x.clone() for x in t]
    D.all_mean_(t[:2])
    D.broadcast_(t)
    for a, b in zip(t, before):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert D.all_sum([0.25, 3.0, 7.0]) == [0.25, 3.0, 7.0]
    assert torch.equal(D.gather_rows(t[1]), before[1])
    mesh = M.make_mesh()
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(AssertionError, match="devices"):
        M.make_mesh((2, 1))


def test_reinit_state_keeps_a_world_of_one(world_of_one):
    cfg, space, jp, ja, jarch = jax_supernet(TINY)
    _, _, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    tree = {"params": params, "alphas": alphas, "arch": arch,
            "step": torch.tensor(3)}
    want = [t.detach().clone() for _, t in named_tensors(tree)]
    assert D.reinit_state(tree) is tree
    got = [t for _, t in named_tensors(tree)]
    assert len(got) == len(want) > 10
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("tensor_parallel", [False, True])
def test_param_sharding_rules_match_jax(tensor_parallel):
    cfg, space, jp, ja, jarch = jax_supernet(TINY)
    _, _, params, _, _ = port_supernet(TINY, jp, ja, jarch)
    jm = jmesh.make_mesh((1, 1), devices=jax.devices()[:1])
    jrules = jmesh.param_sharding_rules(jm, jp,
                                        tensor_parallel=tensor_parallel)
    prules = M.param_sharding_rules(params, tensor_parallel=tensor_parallel)
    from torch.distributed.tensor import Replicate, Shard
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(jrules)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        spec = tuple(sh.spec)
        if spec in ((), (None,), (None, None)):
            want[torch_name(keys)] = Replicate()
        elif spec == (None, "model"):            # (in, out): the out dim
            want[torch_name(keys)] = Shard(0)
        elif spec == ("model", None):            # (in, out): the in dim
            want[torch_name(keys)] = Shard(1)
        else:
            assert spec == ("model",), spec
            want[torch_name(keys)] = Shard(0)
    assert set(prules) == set(dict(params.named_parameters()))
    assert set(prules) <= set(want)
    for name, placement in prules.items():
        assert placement == want[name], name
    sharded = [n for n, p in prules.items() if p != Replicate()]
    if tensor_parallel:
        # qkv, proj, fc1, fc2 weights and the qkv / fc1 biases of each block
        assert len(sharded) == 6 * cfg.depth, sharded
    else:
        assert not sharded


@pytest.mark.parametrize("world,leading_accum", [(2, False), (4, False),
                                                  (2, True), (8, True)])
def test_local_rows_follow_the_jax_batch_sharding(world, leading_accum):
    mb = 3
    shape = (2, world * mb, 5) if leading_accum else (world * mb, 5)
    g = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    jm = jmesh.make_mesh((world, 1), devices=jax.devices()[:world])
    sh = jmesh.batch_sharding(jm, leading_accum=leading_accum)
    arr = jax.device_put(g, sh)
    pos = {d: i for i, d in enumerate(jm.devices.reshape(-1))}
    dim = 1 if leading_accum else 0
    for shard in arr.addressable_shards:
        r = pos[shard.device]
        got = M.local_rows(torch.from_numpy(g), r, world, dim=dim).numpy()
        np.testing.assert_array_equal(got, np.asarray(shard.data))
    with pytest.raises(ValueError, match="does not split"):
        M.local_rows(torch.zeros(world * mb + 1, 2), 0, world)


def test_eval_plan_of_a_small_shard_is_one_smaller_batch():
    # 5 images over 4 ranks: each rank holds 2 indices (one a pad), fewer
    # than a batch of 8, and evaluates them as one batch of 2
    plans = [epoch_plan(5, epoch=0, rank=r, world=4, batch_size=8,
                        repeated_aug=False, train=False, seed=0)
             for r in range(4)]
    assert all(p.shape == (1, 2) for p in plans)
    assert sorted(np.concatenate([p.reshape(-1) for p in plans])) == \
        [0, 0, 1, 1, 2, 2, 3, 4]
    # a shard of at least one batch pads its last batch as before
    assert epoch_plan(20, epoch=0, rank=0, world=2, batch_size=4,
                      repeated_aug=False, train=False, seed=0).shape == (3, 4)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum().item()
    assert prof is not None
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with trace("") as none:
        assert none is None
    assert not os.path.exists(tmp_path / "none")


def test_package_create_model_and_list_models():
    assert ofb_tpu_torch.list_models() == R.list_models()
    assert "deit_small_patch16_224_mim" in ofb_tpu_torch.list_models()
    b = ofb_tpu_torch.create_model("deit_tiny_patch16_224", num_classes=10,
                                   device="cpu")
    want = R.create_model("deit_tiny_patch16_224", num_classes=10,
                          device="cpu")
    assert b.cfg == want.cfg and b.kind == want.kind == "dense"
    assert b.device == torch.device("cpu")
    with pytest.raises(KeyError):
        ofb_tpu_torch.create_model("no_such_model", device="cpu")
