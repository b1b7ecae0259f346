"""The port's tensor-parallel search step (ofb_tpu_torch/parallel/
tensor_parallel.py, `parallel/mesh.py:shard_params`, the sharded blocks of
`models/mim_vit.py`) across real processes: gloo ranks on the CPU on a
(data, model) mesh, against the JAX package's one-device
`make_search_step`, as tests/test_parallel.py holds JAX's own sharded step.

Each mesh's ranks are subprocesses (`tests/torch_tp_worker.py`) that meet
through a `file://` store under tmp_path; every wait has a timeout. All
meshes run at once, while this process computes JAX's steps.

* the config is tests/test_parallel.py's (embed 32, depth 2, MLP 64) with
  the port tests' 16 classes; with 2 heads at the meshes (1, 2), (2, 1),
  (2, 2), and with 4 heads (head dim 8) at (1, 4), since 2 heads cannot
  split 4 ways by heads. A global microbatch of 8, 2 microbatches (the
  multi-process tests' config: clip 1.0, EMA), the PMIM masks JAX draws;
* one search step, then block 0's MLP alpha cell 0 at -8 and a compress
  pass, then a post-prune step; `loss_total` within rtol 2e-4 (JAX's own
  test's), the gathered qkv weight and the embed alphas within atol 2e-5,
  the compress switches and events JAX's;
* the export after a forced convergence equals one process's export of
  the gathered state bit for bit, and the port's one-process run's within
  atol 2e-5; the checkpoint of the sharded state holds the gathered
  tensors; every rank gathers the same state; an eval of each data rank's
  shard of a val set reports one process's whole-set statistics;
* with dropout, attention dropout and drop-path on, every draw from a
  generator and remat on, the (2, 2) mesh's steps are one process's (the
  port's): each shard takes its part of the whole tensor's dropout mask;
* `shard_params` -> `gather_params` is the identity, `tp > H` raises, the
  clip of sharded leaves is optax's `clip_by_global_norm` of the whole
  ones;
* resume (`core/checkpoint.py:load_checkpoint` into a sharded supernet):
  each mesh saves its state after the forced compress, and a fresh
  supernet sharded on the same mesh restores it and takes the post-prune
  step, whose metrics and whole state (leaves, moments, EMA) are the
  uninterrupted step's bit for bit, so within JAX's tolerances above of
  JAX's one-device step; the (2, 2) mesh's checkpoint resumed at (1, 2)
  and in this process (no group) is within them too; the JAX package's
  msgpack checkpoint of the same supernet restored into each mesh's
  sharded supernet gathers to this process's restore of it exactly; in
  process, without a group, each model rank restores its shards of every
  saved tensor, and a checkpoint of another width, head count or MLP
  width raises ValueError naming the leaf and restores nothing.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_multiproc_worker as W
import torch_tp_worker as T
from ofb_tpu import config as JC
from ofb_tpu.core import checkpoint as JCk
from ofb_tpu.core import compress as JCo
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu_torch.models.from_jax import flatten_from_jax
from ofb_tpu_torch.parallel import mesh as M
from test_torch_port_from_jax import (jax_supernet, jax_token_mask, np_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600
MB, KEEP = 8, 0.8
CFG = dict(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2,
           num_heads=2, mlp_ratio=2.0, drop_path_rate=0.0)
CFG4 = dict(CFG, num_heads=4)
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
# dropout, attention dropout and drop-path on, every draw from a generator,
# each block rematerialised: a shard must drop what one process drops, and
# the recompute must replay the model group's collectives (no JAX
# reference: randomness never crosses between the frameworks)
DROP = (2, 2, "drop")
CFG_DROP = dict(CFG4, drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1,
                remat=True)


def _cfg_of(mesh):
    return CFG4 if mesh[1] == 4 else CFG


def _data(cfg_kw):
    """(npz dict, JAX pieces, keys) of one config."""
    jcfg, jspace, jp, ja, jarch = jax_supernet(cfg_kw, seed=9)
    data = {"p." + n: a for n, a in flatten_from_jax(np_tree(jp)).items()}
    data.update({"a." + n: a
                 for n, a in flatten_from_jax(np_tree(ja)).items()})
    data["cfg"] = json.dumps(cfg_kw)
    rng = np.random.default_rng(21)
    data["images"] = rng.uniform(0, 1, (2, W.A, MB, 32, 32, 3)) \
        .astype(np.float32)
    data["labels"] = rng.integers(0, cfg_kw["num_classes"], (2, W.A, MB))
    data["keep"] = np.float32(KEEP)
    keys = [jax.random.PRNGKey(300 + k) for k in range(2)]
    data["masks"] = np.stack([np.stack([
        jax_token_mask(jax.random.split(r, 3)[1], jcfg, MB, KEEP)
        for r in jax.random.split(key, W.A)]) for key in keys])
    return data, (jcfg, jspace, jp, ja, jarch), keys


def _jax_checkpoint(pieces, path):
    """The JAX package's msgpack checkpoint of its supernet: params,
    alphas, arch, the search optimizer's state after one update on random
    gradients (moments not zero, count 1) and half the params as EMA."""
    _, _, jp, ja, jarch = pieces
    jtx, _ = W.build_tx(JO, W.search_cfg(JC))
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(0, 0.1, a.shape), jnp.float32),
        (jp, ja))
    _, jst = jtx.update(grads, jtx.init((jp, ja)), (jp, ja))
    JCk.save_checkpoint(str(path), params=jp, alphas=ja, arch=jarch,
                        opt_state=jst, ema_params=jax.tree_util.tree_map(
                            lambda x: 0.5 * x, jp), meta={"epoch": 0})


def _jax_run(data, pieces, keys):
    """JAX's one-device step, the forced compress and the post-prune step:
    ({tag: {name: array}}, [metrics], compress report, switches)."""
    jcfg, jspace, jp, ja, jarch = pieces
    jscfg = W.search_cfg(JC)
    jtx, _ = W.build_tx(JO, jscfg)
    state = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                          alphas=ja, arch=jarch,
                          opt_state=jtx.init((jp, ja)), ema_params=jp)
    step = JS.make_search_step(jspace, jcfg, jscfg, jtx, phase="search",
                               compute_dtype=jnp.float32, donate=False)

    def leaves(st):
        out = flatten_from_jax(np_tree(st.params))
        out.update({"alphas." + n: a for n, a in
                    flatten_from_jax(np_tree(st.alphas)).items()})
        return out

    got, metrics = {}, []
    state, m = step(state, data["images"][0], data["labels"][0], keys[0],
                    jnp.float32(KEEP))
    metrics.append({n: float(v) for n, v in m.items()})
    got["step0"] = leaves(state)
    al = np.asarray(state.alphas["blocks"][0]["mlp"]).copy()
    al[..., 0] = -8.0
    blocks = list(state.alphas["blocks"])
    blocks[0] = dict(blocks[0], mlp=jnp.asarray(al))
    crafted = dict(state.alphas, blocks=blocks)
    params, alphas, arch, opt, report = JCo.compress(
        state.params, crafted, state.arch, state.opt_state, jspace,
        jscfg.compress_thresh)
    switches = {f"switch.{i}.{k}": np.asarray(getattr(b, k).switch)
                for i, b in enumerate(arch.blocks) for k in ("attn", "mlp")}
    state = state.replace(params=params, alphas=alphas, arch=arch,
                          opt_state=opt)
    state, m = step(state, data["images"][1], data["labels"][1], keys[1],
                    jnp.float32(KEEP))
    metrics.append({n: float(v) for n, v in m.items()})
    got["step1"] = leaves(state)
    return got, metrics, report, switches


def _spawn(mesh, rank, npz, tmp, resume_from=()):
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS"):
        env.pop(k, None)
    dp, tp = mesh
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_tp_worker.py"),
         str(rank), str(dp * tp), str(dp), str(tp), str(tmp / "rdzv"),
         str(npz), str(tmp), *map(str, resume_from)],
        env=env, cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _last_json(out):
    for line in reversed(out.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    raise AssertionError(f"no JSON line in: {out[-1500:]}")


def _finish(procs):
    """The JSON results of one mesh's ranks, once they exit."""
    results = []
    for p in procs:
        o, e = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, (e[-3000:], o[-1500:])
        results.append(_last_json(o))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: (rank results, rank arrays, its directory)} of every mesh's
    ranks and, under "cross", {"1x2" / "1": (results, arrays)} of the (2, 2)
    mesh's checkpoint resumed at (1, 2) and in this process; and {heads:
    (data, JAX's run, the port's one-process run, this process's restore
    of the JAX checkpoint)}."""
    root = tmp_path_factory.mktemp("tp")
    datas = {}
    for kw in (CFG, CFG4):
        data, pieces, keys = _data(kw)
        data["jax_ckpt"] = str(root / f"jax{kw['num_heads']}")
        _jax_checkpoint(pieces, data["jax_ckpt"])
        npz = root / f"data{kw['num_heads']}.npz"
        np.savez(npz, **data)
        datas[kw["num_heads"]] = (npz, pieces, keys)
    drop = dict(_data(CFG_DROP)[0], gen_seed=np.int64(17))
    np.savez(root / "drop.npz", **drop)
    procs = {}
    for mesh in MESHES + [DROP]:
        tmp = root / f"mesh{mesh[0]}x{mesh[1]}{''.join(mesh[2:])}"
        tmp.mkdir()
        npz = root / "drop.npz" if mesh == DROP \
            else datas[_cfg_of(mesh)["num_heads"]][0]
        procs[mesh] = (tmp, [_spawn(mesh[:2], r, npz, tmp)
                             for r in range(mesh[0] * mesh[1])])
    refs, cross = {}, []
    try:
        for heads, (npz, pieces, keys) in datas.items():
            data = np.load(npz)
            jstate = T.restored(data, str(data["jax_ckpt"]))[0]
            refs[heads] = (data, _jax_run(data, pieces, keys),
                           T.run(data, out=None),
                           T.gathered(jstate, "jaxck", ("mu", "nu"),
                                      ema=True))
        refs["drop"] = T.run(np.load(root / "drop.npz"))
        out = {}
        for mesh, (tmp, ps) in procs.items():
            results = _finish(ps)
            if mesh == (2, 2):
                # the (2, 2) mesh's checkpoint resumed at (1, 2)
                ctmp = root / "cross1x2"
                ctmp.mkdir()
                cross = [_spawn((1, 2), r, datas[2][0], ctmp,
                                [tmp / "resume"]) for r in range(2)]
            arrays = [dict(np.load(tmp / f"rank{r}.npz"))
                      for r in range(len(ps))]
            out[mesh] = (results, arrays, tmp)
        # ... and in this process, without a group
        one = T.resume(refs[2][0], str(out[(2, 2)][2] / "resume"))
        out["cross"] = {"1": ([{"resumed": one[1]}], [one[0]]),
                        "1x2": (_finish(cross), [
                            dict(np.load(ctmp / f"rank{r}.npz"))
                            for r in range(2)])}
    finally:
        for ps in [ps for _, ps in procs.values()] + [cross]:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return out, refs


def _ref(runs, mesh):
    return runs[1][_cfg_of(mesh)["num_heads"]]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_step_matches_jax_one_device(runs, mesh):
    results, arrays, _ = runs[0][mesh]
    _, (jgot, jmetrics, _, _), _, _ = _ref(runs, mesh)
    a = arrays[0]
    for k, tag in enumerate(("step0", "step1")):
        np.testing.assert_allclose(results[0]["metrics"][k]["loss_total"],
                                   jmetrics[k]["loss_total"], rtol=2e-4)
        for name in ("blocks.0.attn.qkv.weight", "alphas.embed"):
            np.testing.assert_allclose(a[f"{tag}.{name}"], jgot[tag][name],
                                       rtol=0, atol=2e-5, err_msg=name)
    # the whole state, not only JAX's spot checks
    for name, want in jgot["step1"].items():
        np.testing.assert_allclose(a[f"step1.{name}"], want, rtol=0,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ranks_gather_one_state(runs, mesh):
    results, arrays, _ = runs[0][mesh]
    for r in range(1, len(arrays)):
        assert set(arrays[r]) == set(arrays[0])
        for n in arrays[0]:
            assert np.array_equal(arrays[r][n], arrays[0][n]), (r, n)
        assert results[r]["switch_digest"] == results[0]["switch_digest"]
        assert results[r]["metrics"] == results[0]["metrics"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_forced_compress_takes_jax_decisions(runs, mesh):
    results, arrays, _ = runs[0][mesh]
    _, (_, _, jreport, jswitch), _, _ = _ref(runs, mesh)
    assert jreport.execute_prune
    assert results[0]["events"] == list(jreport.events)
    for name, want in jswitch.items():
        assert np.array_equal(arrays[0][name], want), name


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gathered_export_equals_one_process(runs, mesh):
    results, arrays, _ = runs[0][mesh]
    _, _, (single, srun), _ = _ref(runs, mesh)
    assert results[0]["finished"] and srun["finished"]
    assert results[0]["block_dims"] == srun["block_dims"]
    a = arrays[0]
    exported = sorted(n for n in a if n.startswith("export."))
    assert exported and exported == sorted(n for n in single
                                           if n.startswith("export."))
    for n in exported:
        np.testing.assert_allclose(a[n], single[n], rtol=0, atol=2e-5,
                                   err_msg=n)
    # the eval of each data rank's shard reports the whole set's
    # statistics, the same as one process's (a model group's ranks score
    # the same rows: summed over the data group only)
    assert results[0]["eval"]["acc1"] == srun["eval"]["acc1"]
    assert results[0]["eval"]["acc5"] == srun["eval"]["acc5"]
    assert results[0]["eval"]["loss"] == pytest.approx(srun["eval"]["loss"],
                                                       rel=1e-5)
    # ... and the one-process state the mesh ran is the port's too
    for n in single:
        if n.startswith(("step1.", "ema.")):
            np.testing.assert_allclose(a[n], single[n], rtol=0, atol=2e-5,
                                       err_msg=n)


def test_export_of_the_gathered_state_is_exact(runs):
    """The mesh's export is one process's export of the same gathered
    leaves, bit for bit (the export gathers, then slices)."""
    from ofb_tpu_torch.core.checkpoint import load_checkpoint
    from ofb_tpu_torch.core.export import export_subnet
    from ofb_tpu_torch.models.mim_vit import MimViT
    from ofb_tpu_torch.models.search_space import ArchState, SearchSpace
    from ofb_tpu_torch.models.vit import ModelCfg
    _, arrays, tmp = runs[0][(1, 4)]
    cfg = ModelCfg(**CFG4)
    space = SearchSpace.build(cfg.embed_dim, cfg.depth, cfg.num_heads,
                              cfg.hidden, cfg.num_patches, patch_search=True)
    # the checkpoint rank 0 wrote after the post-prune step: the gathered
    # tensors, one-process names and shapes
    params, arch = MimViT(cfg, space), ArchState.create(space)
    load_checkpoint(str(tmp / "ckpt"), params=params, arch=arch)
    for n, p in params.named_parameters():
        assert np.array_equal(p.detach().numpy(), arrays[0][f"step1.{n}"]), n
    ema = torch.load(tmp / "ckpt" / "ema.pt")
    for n, t in ema.items():
        assert np.array_equal(t.numpy(), arrays[0][f"ema.{n}"]), n
    opt = torch.load(tmp / "ckpt" / "opt_state.pt")
    n = "blocks.1.mlp.fc1.weight"
    assert np.array_equal(opt[f"mu.{n}"].numpy(), arrays[0][f"step1.mu.{n}"])
    # export of those gathered leaves in one process, after the same
    # forced convergence the ranks ran
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.models.mim_vit import Alphas
    from ofb_tpu_torch.core.steps import TrainState
    alphas = Alphas(space)
    load_checkpoint(str(tmp / "ckpt"), alphas=alphas)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=None)
    B.force_convergence(state, space)
    dense, _, _ = export_subnet(params, arch, space, cfg)
    for n, p in dense.named_parameters():
        assert np.array_equal(p.detach().numpy(), arrays[0][f"export.{n}"]), n


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_shard_then_gather_is_the_identity(runs, mesh):
    results, _, _ = runs[0][mesh]
    for r in results:
        assert r["gather_identity"]
        # the qkv / fc1 weights and biases and the proj / fc2 weights of
        # each block are sharded when the model axis has two ranks or more
        assert len(r["sharded"]) == (6 * 2 if mesh[1] > 1 else 0)


def test_sharded_dropout_draws_what_one_process_draws(runs):
    results, arrays, _ = runs[0][DROP]
    single, srun = runs[1]["drop"]
    for mine, theirs in zip(results[0]["metrics"], srun["metrics"]):
        assert mine["loss_total"] == pytest.approx(theirs["loss_total"],
                                                   rel=1e-5)
    for n in single:
        if n.startswith(("step0.", "step1.")):
            np.testing.assert_allclose(arrays[0][n], single[n], rtol=0,
                                       atol=2e-5, err_msg=n)
    for r in range(1, len(arrays)):
        for n in arrays[0]:
            assert np.array_equal(arrays[r][n], arrays[0][n]), (r, n)


@pytest.mark.parametrize("heads,tp", [(2, 2), (4, 4), (6, 4), (6, 5), (3, 2)])
def test_shards_cut_and_put_back_in_process(heads, tp):
    """shard_tensor on every rank, then unshard_tensor, is the identity;
    heads split as np.array_split splits them."""
    from ofb_tpu_torch.models.vit import ModelCfg
    cfg = ModelCfg(embed_dim=8 * heads, num_heads=heads, mlp_ratio=2.0)
    lay = [M.tp_layout(cfg, tp, r) for r in range(tp)]
    assert lay[0].heads == tuple(len(a) for a in np.array_split(
        np.arange(heads), tp))
    g = torch.Generator().manual_seed(heads * 10 + tp)
    D, hd, hid = cfg.embed_dim, cfg.hd, cfg.hidden
    shapes = {"blocks.0.attn.qkv.weight": (3 * heads * hd, D),
              "blocks.0.attn.qkv.bias": (3 * heads * hd,),
              "blocks.0.attn.proj.weight": (D, heads * hd),
              "blocks.0.mlp.fc1.weight": (hid, D),
              "blocks.0.mlp.fc1.bias": (hid,),
              "blocks.0.mlp.fc2.weight": (D, hid),
              "blocks.0.mlp.fc2.bias": (D,)}
    for name, shape in shapes.items():
        full = torch.randn(shape, generator=g)
        pieces = [M.shard_tensor(name, full, lay[r]) for r in range(tp)]
        assert torch.equal(M.unshard_tensor(name, pieces, lay[0]), full)
    # a rank's qkv rows are q, k and v of its own heads
    h0, h1 = lay[-1].head_range()
    qkv = torch.arange(3 * heads * hd)
    got = M.shard_tensor("blocks.0.attn.qkv.bias", qkv, lay[-1])
    want = qkv.reshape(3, heads, hd)[:, h0:h1].reshape(-1)
    assert torch.equal(got, want)


def test_model_axis_above_the_head_count_raises():
    from ofb_tpu_torch.models.vit import ModelCfg
    with pytest.raises(ValueError, match="cannot split over 4 model ranks"):
        M.tp_layout(ModelCfg(**CFG), 4, 0)
    with pytest.raises(ValueError, match="heads"):
        M.split_sizes(6, 7, "heads")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_clip_of_sharded_leaves_is_optax(runs, mesh):
    _, arrays, _ = runs[0][mesh]
    data = _ref(runs, mesh)[0]
    grads = {n: g.numpy() for n, g in T.clip_grads(data).items()}
    want = optax.clip_by_global_norm(0.5).update(
        {n: jnp.asarray(g) for n, g in grads.items()}, None)[0]
    for n, g in want.items():
        np.testing.assert_allclose(arrays[0][f"clip.{n}"], np.asarray(g),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


# ---------------------------------------------------------------------------
# resume into a sharded supernet
# ---------------------------------------------------------------------------

def _close_to_jax(metrics, a, tag, jgot, jmetrics):
    """The post-prune step's loss within JAX's rtol, and every gathered
    leaf (the qkv weights and the alphas among them) within its atol, of
    JAX's one-device post-prune step."""
    np.testing.assert_allclose(metrics["loss_total"],
                               jmetrics[1]["loss_total"], rtol=2e-4)
    for name, want in jgot["step1"].items():
        np.testing.assert_allclose(a[f"{tag}.{name}"], want, rtol=0,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_resumed_step_is_the_uninterrupted_one(runs, mesh):
    """The checkpoint saved after the forced compress, restored into a
    fresh supernet sharded on the same mesh: its post-prune step's metrics
    and its whole state (every leaf, both moments, EMA) are the
    uninterrupted step's bit for bit on every rank."""
    results, arrays, _ = runs[0][mesh]
    _, (jgot, jmetrics, _, _), _, _ = _ref(runs, mesh)
    for r, a in zip(results, arrays):
        assert r["resumed"] == r["metrics"][1]
        step1 = [n for n in a if n.startswith("step1.")]
        assert any(".nu." in n for n in step1) and any(
            ".ema." in n for n in step1)
        assert sorted("resumed." + n[6:] for n in step1) == sorted(
            n for n in a if n.startswith("resumed."))
        for n in step1:
            assert np.array_equal(a["resumed." + n[6:]], a[n]), n
    _close_to_jax(results[0]["resumed"], arrays[0], "resumed", jgot,
                  jmetrics)


@pytest.mark.parametrize("to", ["1x2", "1"])
def test_resume_across_meshes_matches_jax(runs, to):
    """The (2, 2) mesh's checkpoint resumed at (1, 2) and in one process
    (this one, no group): the post-prune step within JAX's tolerances of
    JAX's one-device step; the ranks of (1, 2) agree bit for bit."""
    results, arrays = runs[0]["cross"][to]
    _, (jgot, jmetrics, _, _), _, _ = _ref(runs, (2, 2))
    _close_to_jax(results[0]["resumed"], arrays[0], "resumed", jgot,
                  jmetrics)
    for r, a in zip(results[1:], arrays[1:]):
        assert r == results[0]
        for n in arrays[0]:
            assert np.array_equal(a[n], arrays[0][n]), n


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_jax_checkpoint_restores_into_the_sharded_supernet(runs, mesh):
    """The JAX package's msgpack checkpoint of the same supernet, restored
    into a fresh supernet sharded on the mesh: its gathered params,
    alphas, moments and EMA are this process's restore of the file
    exactly, the update count JAX's."""
    results, arrays, _ = runs[0][mesh]
    want = _ref(runs, mesh)[3]
    got = {n: t for n, t in arrays[0].items() if n.startswith("jaxck.")}
    assert set(got) == set(want) and any(".nu." in n for n in got)
    for n, t in want.items():
        assert np.array_equal(got[n], t), n
    assert np.abs(want["jaxck.mu.blocks.0.attn.qkv.weight"]).max() > 0
    assert [r["jaxck_count"] for r in results] == [1] * len(results)


class _ModelAxis:
    """What `shard_params` reads of a (1, size) mesh at one model rank: a
    rank's shards without a process group (a restore takes no
    collective)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, size, rank):
        self.n, self.rank = size, rank

    def size(self, dim):
        return (1, self.n)[dim]

    def get_local_rank(self, name):
        assert name == "model"
        return self.rank


def _parts(path):
    return {n: torch.load(os.path.join(path, f"{n}.pt"))
            for n in ("params", "alphas", "arch", "opt_state", "ema")}


def _state_tensors(state):
    from ofb_tpu_torch.core import checkpoint as ck
    return {f"{part}.{n}": t.detach().clone() for part, obj in (
        ("params", state.params), ("alphas", state.alphas),
        ("arch", state.arch), ("opt_state", state.opt_state),
        ("ema", state.ema_params)) for n, t in ck._live(part, obj).items()}


@pytest.mark.parametrize("heads,tp", [(2, 2), (4, 4), (4, 2)])
def test_each_rank_restores_its_shards_in_process(runs, heads, tp):
    """The one-process checkpoint of the (2, 2) / (1, 4) mesh's state after
    the forced compress, and the JAX package's checkpoint, restored at
    each model rank of `tp` without a group: every sharded leaf of the
    params, moments and EMA is `shard_tensor` of the saved full tensor
    (for the JAX file, of this process's restore of it), every other
    tensor the saved one."""
    from ofb_tpu_torch.core import checkpoint as ck
    data = runs[1][heads][0]
    path = str(runs[0][(2, 2) if heads == 2 else (1, 4)][2] / "resume")
    saved = _parts(path)
    one = _state_tensors(T.restored(data, str(data["jax_ckpt"]))[0])
    for rank in range(tp):
        state = T.build(data, _ModelAxis(tp, rank), seed=7)[2]
        layout = M.tp_of(state.params)
        assert layout is not None and layout.rank == rank
        for src, want in ((path, {f"{p}.{n}": t for p, part in saved.items()
                                  for n, t in part.items()}),
                          (str(data["jax_ckpt"]), one)):
            ck.load_checkpoint(src, params=state.params, alphas=state.alphas,
                               arch=state.arch, opt_state=state.opt_state,
                               ema_params=state.ema_params)
            got = _state_tensors(state)
            assert set(got) == set(want)
            cut = 0
            for n, t in got.items():
                part, leaf = n.split(".", 1)
                w = want[n]
                if part in ck.SHARDED_PARTS and M.shard_kind(leaf):
                    w = M.shard_tensor(leaf, w, layout)
                    cut += w.shape != want[n].shape
                assert torch.equal(t, w), (src, rank, n)
            # 6 sharded leaves a block, in params, mu, nu and EMA
            assert cut == 6 * 2 * 4


@pytest.mark.parametrize("other,leaf", [
    # wider: every sharded leaf differs; qkv comes first
    (dict(embed_dim=48, num_heads=3),
     r"params\.blocks\.0\.attn\.qkv\.weight saved \(144, 48\), live a "
     r"shard \(48, 32\) of \(96, 32\)"),
    # 4 heads of 8 at the same width: the sharded leaves fit, the
    # replicated head score does not
    (dict(num_heads=4),
     r"params\.blocks\.0\.attn\.score saved \(4, 8\), live \(1, 16\)"),
    # a wider MLP
    (dict(mlp_ratio=3.0),
     r"params\.blocks\.0\.mlp\.fc1\.weight saved \(96, 32\), live a "
     r"shard \(32, 32\) of \(64, 32\)")], ids=["width", "heads", "mlp"])
def test_another_width_or_head_count_raises_naming_the_leaf(runs, tmp_path,
                                                            other, leaf):
    """A checkpoint of another width, head count or MLP width, restored
    into the (2 heads, embed 32) supernet sharded at model rank 1 of 2:
    ValueError naming the first leaf that does not fit (a sharded leaf's
    saved full tensor against the full shape of its live shard; a
    replicated leaf's against the live one), and nothing is restored."""
    from ofb_tpu_torch.core import checkpoint as ck
    src = T.build({"cfg": json.dumps(dict(CFG, **other))}, seed=3)[2]
    ck.save_checkpoint(str(tmp_path / "other"), params=src.params,
                       alphas=src.alphas, arch=src.arch,
                       opt_state=src.opt_state, ema_params=src.ema_params)
    state = T.build(runs[1][2][0], _ModelAxis(2, 1), seed=7)[2]
    before = _state_tensors(state)
    with pytest.raises(ValueError, match=leaf):
        ck.load_checkpoint(str(tmp_path / "other"), params=state.params,
                           alphas=state.alphas, arch=state.arch,
                           opt_state=state.opt_state,
                           ema_params=state.ema_params)
    after = _state_tensors(state)
    for n, t in before.items():
        assert torch.equal(after[n], t), n
