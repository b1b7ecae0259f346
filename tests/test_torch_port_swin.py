"""The port's dense Swin (ofb_tpu_torch/models/swin.py) against ofb_tpu's on
the CPU, from the same weights, and the Swin test support the other
`test_torch_port_swin_*` files import.

The tiny geometry is 32 x 32 images, patch 2, D 24, two stages of two
blocks (heads 2 and 4), window 4: stage 0 works on 16 x 16 tokens and
stage 1 on 8 x 8, so the second block of each stage shifts its windows
and takes the shift mask, and one patch merging joins the stages.
Weights come from the JAX tree, scaled 3x (a trunc-normal .02 init makes
q.k ~ 0 and would hide a wrong softmax scale); no stochastic depth.

Tolerances: the window helpers, the relative index, the shift mask and
the FLOPs count exactly; fp32 logits and every weight's gradient rtol
1e-5 with atol 1e-5 of the largest magnitude; the dense train step as
test_torch_port_step.py's: loss rel 1e-5, parameters atol 2e-5, moments
rtol 1e-3 + 1e-4 of the leaf's largest magnitude; bf16 logits atol 2e-2
of the largest magnitude.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ofb_tpu.config import ScheduleConfig as JSched
from ofb_tpu.core import checkpoint as JCk
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu.core import swin_steps as JSS
from ofb_tpu.models import registry as JR
from ofb_tpu.models import search_space as JSs
from ofb_tpu.models import swin as js
from ofb_tpu.models import swin_search as jss
from ofb_tpu_torch.config import ScheduleConfig
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.core import optim as O
from ofb_tpu_torch.core import swin_steps as SS
from ofb_tpu_torch.core.steps import TrainState
from ofb_tpu_torch.models import registry as R
from ofb_tpu_torch.models import swin as S
from ofb_tpu_torch.models import swin_search as SWS
from ofb_tpu_torch.models.from_jax import (arch_from_jax, flatten_from_jax,
                                           load_from_jax, to_jax)
from test_torch_port_from_jax import np_tree

torch.set_num_threads(1)

CFG = dict(img_size=32, patch_size=2, num_classes=10, embed_dim=24,
           depths=(2, 2), num_heads=(2, 4), window=4, mlp_ratio=2.0,
           drop_path_rate=0.0)
SWIN_NAMES = [n for n in JR.list_models() if n.startswith("swin")]


def scaled(tree, k=3.0):
    """Weights (2-D and up) times k, for realistic attention logits."""
    return jax.tree_util.tree_map(lambda a: a * k if a.ndim >= 2 else a,
                                  tree)


def jax_swin_supernet(seed=0, cfg_kw=CFG, **space_kw):
    """(cfg, space, params, alphas, arch) of the JAX package, weights
    scaled 3x."""
    cfg = js.SwinCfg(**cfg_kw)
    space = jss.build_swin_space(cfg, **space_kw)
    p, a, arch = jss.init_swin_search(jax.random.PRNGKey(seed), cfg, space)
    return cfg, space, scaled(p), a, arch


def port_swin_supernet(jp, ja, jarch, cfg_kw=CFG, **space_kw):
    """The port's (cfg, space, params, alphas, arch) holding the JAX
    weights and state, on the CPU."""
    cfg = S.SwinCfg(**cfg_kw)
    space = SWS.build_swin_space(cfg, **space_kw)
    return (cfg, space, load_from_jax(SWS.SwinSearch(cfg, space), np_tree(jp)),
            load_from_jax(SWS.SwinAlphas(space), np_tree(ja)),
            arch_from_jax(jarch))


def images(n=2, seed=1, size=32):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, size, size, 3)).astype(np.float32)


def close(got, want, name="", rtol=1e-5, atol=1e-5):
    scale = float(np.abs(want).max()) + 1e-30
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=name)


# ---------------------------------------------------------------------------
# window helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,w", [((2, 16, 16, 5), 4), ((1, 8, 8, 3), 4),
                                     ((2, 14, 14, 4), 7)])
def test_window_partition_and_reverse_match_jax(shape, w):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    win = S.window_partition(torch.from_numpy(x), w)
    want = np.asarray(js.window_partition(jnp.asarray(x), w))
    np.testing.assert_array_equal(win.numpy(), want)
    back = S.window_reverse(win, w, shape[1], shape[2])
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(js.window_reverse(jnp.asarray(want), w,
                                                   shape[1], shape[2])))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("w", [2, 4, 7])
def test_relative_position_index_matches_jax(w):
    got = S.relative_position_index(w)
    np.testing.assert_array_equal(got, js.relative_position_index(w))
    assert got.dtype == np.int32 and got.max() == (2 * w - 1) ** 2 - 1


@pytest.mark.parametrize("res,w", [(16, 4), (8, 4), (56, 7), (28, 7),
                                   (14, 7)])
def test_shifted_window_mask_matches_jax(res, w):
    got = S.shifted_window_mask(res, w, w // 2)
    np.testing.assert_array_equal(got, js.shifted_window_mask(res, w, w // 2))
    assert got.shape == ((res // w) ** 2, w * w, w * w)
    # the last window mixes four regions, the first none
    assert (got[0] == 0).all() and (got[-1] < 0).any()


# ---------------------------------------------------------------------------
# dense forward and gradients
# ---------------------------------------------------------------------------

def _dense_pair(seed=0):
    jcfg = js.SwinCfg(**CFG)
    tree = scaled(js.init_swin_params(jax.random.PRNGKey(seed), jcfg))
    cfg = S.SwinCfg(**CFG)
    return jcfg, tree, cfg, load_from_jax(S.Swin(cfg), np_tree(tree))


@pytest.mark.parametrize("pack", ["1", "2"])
def test_dense_forward_and_gradients_match_jax(pack, monkeypatch):
    """The JAX forward with its window packing on (2, the default) and off
    (1): the port computes the unpacked form of the same math."""
    monkeypatch.setenv("OFB_SWIN_PACK", pack)
    jcfg, tree, cfg, params = _dense_pair()
    x = images(4)
    w = np.random.default_rng(3).normal(size=(4, 10)).astype(np.float32)

    def loss(p):
        logits = js.swin_forward(p, jnp.asarray(x), jcfg,
                                 compute_dtype=jnp.float32)
        return jnp.sum(logits * w), logits
    (_, jlogits), jg = jax.value_and_grad(loss, has_aux=True)(tree)
    logits = S.swin_forward(params, torch.from_numpy(x), cfg,
                            compute_dtype=torch.float32)
    (logits * torch.from_numpy(w)).sum().backward()
    close(logits.detach().numpy(), np.asarray(jlogits), "logits")
    want = flatten_from_jax(np_tree(jg))
    got = {n: p.grad.numpy() for n, p in params.named_parameters()}
    assert set(got) == set(want)
    assert "stages.0.blocks.1.attn.rel_bias" in got
    assert "stages.0.downsample.reduction.weight" in got
    for n, g in want.items():
        close(got[n], g, n)


def test_window_attention_range_and_its_backward_are_traced():
    """`bench.py --profile` reads the window attention's share from a
    step's own trace: one profiler range for each block's call, and the
    backward nodes that the range's ops made (the two batched products,
    the softmax, the bias gather), none of the qkv or proj linears'."""
    from torch.profiler import ProfilerActivity, profile

    from ofb_tpu_torch import bench as B
    cfg = S.SwinCfg(**CFG)
    params = S.Swin(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(images(2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        S.swin_forward(params, x, cfg,
                       compute_dtype=torch.float32).sum().backward()
    ranges, nodes = B.range_events(prof, S.WINDOW_ATTENTION_RANGE)
    blocks = sum(cfg.depths)
    assert len(ranges) == blocks
    names = [n.name.split(": ")[-1] for n in nodes]
    assert names.count("BmmBackward0") == 2 * blocks
    assert names.count("SoftmaxBackward0") == blocks
    assert names.count("IndexBackward0") == blocks
    assert not {"AddmmBackward0", "MmBackward0", "LinearBackward0"} & set(
        names)


def test_dense_bf16_forward_matches_jax():
    jcfg, tree, cfg, params = _dense_pair(seed=2)
    x = images(2, seed=5)
    want = np.asarray(js.swin_forward(tree, jnp.asarray(x), jcfg,
                                      compute_dtype=jnp.bfloat16))
    got = S.swin_forward(params, torch.from_numpy(x), cfg,
                         compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    close(got.detach().numpy(), want, rtol=0, atol=2e-2)


def test_dense_flops_match_the_jax_total():
    for name in ("swin_tiny_patch4_window7_224_mim",
                 "swin_base_patch4_window7_224_mim"):
        jb = JR.create_model(name)
        a = {"patch": jnp.ones(1), "embed": jnp.ones(1), "blocks": [
            {"attn": jnp.ones(b.attn.num_cells),
             "mlp": jnp.ones(b.mlp.num_cells)} for b in jb.space.blocks]}
        total, _ = jss.swin_model_flops(a, JSs.ArchState.create(jb.space),
                                        jb.space, jb.cfg)
        cfg = R.create_model(name, device="cpu").cfg
        assert np.float32(S.swin_dense_flops(cfg)) == pytest.approx(
            float(total), rel=1e-6)


# ---------------------------------------------------------------------------
# registry and weights both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SWIN_NAMES)
def test_swin_registry_matches_jax(name):
    kw = dict(embed_search=True) if name.endswith("_mim") else {}
    jb = JR.create_model(name, num_classes=7, **kw)
    pb = R.create_model(name, device="cpu", num_classes=7, **kw)
    assert dataclasses.asdict(pb.cfg) == dataclasses.asdict(jb.cfg)
    assert pb.kind == jb.kind
    if jb.kind == "swin_mim":
        assert dataclasses.asdict(pb.space) == dataclasses.asdict(jb.space)
        assert len(pb.space.stage_embeds) == 4


def test_weights_round_trip_through_to_jax():
    jcfg, jspace, jp, ja, jarch = jax_swin_supernet(embed_search=True)
    cfg, space, params, alphas, arch = port_swin_supernet(
        jp, ja, jarch, embed_search=True)
    for tree, module in ((jp, params), (ja, alphas)):
        back = to_jax(module)
        assert jax.tree_util.tree_structure(np_tree(tree)) == \
            jax.tree_util.tree_structure(back)
        for a, b in zip(jax.tree_util.tree_leaves(np_tree(tree)),
                        jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(a, b)
    # the port's own init has the JAX tree's names and shapes
    mine = SWS.SwinSearch(cfg, space, torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in mine.named_parameters()} == {
        n: a.shape for n, a in flatten_from_jax(np_tree(jp)).items()}


# ---------------------------------------------------------------------------
# dense train and eval steps
# ---------------------------------------------------------------------------

def test_dense_train_and_eval_steps_match_jax():
    """3 steps of 2 accumulated microbatches of 4 (cosine AdamW, weight
    decay 0.05, the export finetune's optimizer), then the eval step. The
    peak learning rate is test_torch_port_step.py's order (~1e-3): the k
    third of a qkv bias has an analytically zero gradient (it shifts a
    whole softmax row), so Adam moves it by ~lr on rounding noise whose
    sign the two frameworks need not share."""
    jcfg, tree, cfg, params = _dense_pair(seed=4)
    K, A, MB = 3, 2, 4
    sched = dict(warmup_lr=1e-4, min_lr=1e-5, warmup_epochs=1)
    jtx = optax.adamw(JO.cosine_schedule(2e-3, JSched(**sched), 8, 2),
                      weight_decay=0.05)
    tx = O.adamw(O.cosine_schedule(2e-3, ScheduleConfig(**sched), 8, 2),
                 weight_decay=0.05)
    init = {n: p.detach().clone() for n, p in params.named_parameters()}
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=tree,
                           alphas=None, arch=None, opt_state=jtx.init(tree))
    state = TrainState(step=0, params=params, alphas=None, arch=None,
                       opt_state=tx.init(dict(params.named_parameters())))
    jstep = JSS.make_swin_train_step_dense(jcfg, jtx,
                                           compute_dtype=jnp.float32)
    step = SS.make_swin_train_step_dense(cfg, tx, compute_dtype=torch.float32,
                                         device="cpu")
    rng = np.random.default_rng(6)
    for k in range(K):
        x = rng.uniform(0, 1, (A, MB, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, (A, MB))
        jstate, jm = jstep(jstate, x, y, jax.random.PRNGKey(k))
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert int(state.step) == int(jstate.step) == K * A
    want = flatten_from_jax(np_tree(jstate.params))
    for n, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=2e-5, err_msg=n)
        assert (p.detach() - init[n]).abs().max() > 1e-4, n
    adam = jstate.opt_state[0]
    for which in ("mu", "nu"):
        ref = flatten_from_jax(np_tree(getattr(adam, which)))
        for n, t in getattr(state.opt_state, which).items():
            np.testing.assert_allclose(
                t.numpy(), ref[n], rtol=1e-3,
                atol=1e-4 * float(np.abs(ref[n]).max()) + 1e-30, err_msg=n)

    x, y = images(6, seed=7), np.arange(6) % 10
    jev = JSS.make_swin_eval_step_dense(jcfg, compute_dtype=jnp.float32)(
        jstate.params, x, y)
    ev = SS.make_swin_eval_step_dense(cfg, compute_dtype=torch.float32,
                                      device="cpu")(params,
                                                    torch.from_numpy(x),
                                                    torch.from_numpy(y))
    for k in ("loss_sum", "top1", "top5", "count"):
        assert ev[k].item() == pytest.approx(float(jev[k]), rel=1e-5), k


# ---------------------------------------------------------------------------
# checkpoints: Swin metas, the port's and the JAX package's
# ---------------------------------------------------------------------------

def _widths_meta():
    return {"exported": True, "family": "swin",
            "blocks": [{"mlp_hidden": h} for h in (24, 12, 48, 72)],
            "stage_dims": [18, 36]}


def test_swin_subnet_checkpoints_load_by_meta(tmp_path):
    cfg = S.SwinCfg(**CFG)
    meta = {**_widths_meta(), "model_cfg": dataclasses.asdict(cfg)}
    model = S.Swin(cfg, generator=torch.Generator().manual_seed(1),
                   **S.subnet_widths(meta))
    assert model.stages[0].blocks[1].mlp.fc1.weight.shape == (12, 18)
    assert model.stages[0].blocks[0].attn.qkv.weight.shape == (72, 18)
    assert model.stages[0].downsample.reduction.weight.shape == (36, 72)
    # the port's format
    ck.save_checkpoint(str(tmp_path / "port"), params=model, meta=meta)
    back, bcfg = ck.swin_from_meta(ck.latest_meta(str(tmp_path / "port")))
    assert bcfg == cfg
    ck.load_checkpoint(str(tmp_path / "port"), params=back)
    # the JAX package's format (msgpack) of the same tree
    JCk.save_checkpoint(str(tmp_path / "jax"), params=to_jax(model),
                        meta=json_safe(meta))
    jback, _ = ck.swin_from_meta(ck.latest_meta(str(tmp_path / "jax")))
    ck.load_checkpoint(str(tmp_path / "jax"), params=jback)
    for (n, a), b, c in zip(model.named_parameters(), back.parameters(),
                            jback.parameters()):
        assert torch.equal(a, b) and torch.equal(a, c), n
    x = torch.from_numpy(images(2))
    out = S.swin_forward(jback, x, bcfg, compute_dtype=torch.float32)
    assert out.shape == (2, 10) and torch.isfinite(out).all()


def json_safe(meta):
    return json.loads(json.dumps(meta))


def test_dense_swin_meta_builds_the_dense_widths():
    cfg = S.SwinCfg(**CFG)
    model, got = ck.swin_from_meta({"exported": True, "family": "swin",
                                    "from_scratch": True,
                                    "model_cfg": json_safe(
                                        dataclasses.asdict(cfg))})
    assert got == cfg
    ref = S.Swin(cfg)
    assert [p.shape for p in model.parameters()] == \
        [p.shape for p in ref.parameters()]
