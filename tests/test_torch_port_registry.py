"""The port's model registry (ofb_tpu_torch/models/registry.py) and the ViT
family's pieces against ofb_tpu on the CPU, in fp32, from the same weights:

* every name of the JAX registry but the Swin family's (50: the DeiT
  supernets and dense models, the stock ViTs, in21k, MIIL and the
  `vit_deit_*` aliases) builds the same config (`remat` among its fields)
  with the same default class count and kind; so do
  the six Swin names (dense and searchable), whose family the port now
  has;
* a tiny in21k-style ViT (tanh pre-logits, `representation_size`): logits
  and the gradients of every weight against `vit_forward` and `jax.grad`
  (rtol 1e-5, atol 1e-5 of the largest magnitude); `from_jax` / `to_jax`
  carry `pre_logits` both ways; a distilled model has none;
* a tiny supernet without the qkv bias (MIIL): the gated forward, `fuse`
  and `export` against JAX's (logits atol 2e-4 / rtol 1e-4, the export's
  tensors rtol 1e-6, as test_torch_port_export.py). JAX's `export_subnet`
  needs a qkv bias, so its reference is the export of the same tree with
  zero qkv biases, those dropped;
* a patch size that does not divide the image (ViT-H/14 at 384: 27 x 27
  patches of VALID convolution, 6 pixels dropped): a tiny ViT's logits
  against JAX's, and the pos-embed resized from 14 x 14 to 27 x 27 as
  JAX's `interpolate_pos_embed` resizes it;
* `register_model`: a factory registered in both packages is listed and
  created, with the same config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.core import export as JE
from ofb_tpu.models import mim_vit as jmim
from ofb_tpu.models import pos_embed as JP
from ofb_tpu.models import registry as JR
from ofb_tpu.models import vit as jvit
from ofb_tpu_torch.core.export import export_subnet
from ofb_tpu_torch.models import pos_embed as P
from ofb_tpu_torch.models import registry as R
from ofb_tpu_torch.models.from_jax import (flatten_from_jax, load_from_jax,
                                           to_jax)
from ofb_tpu_torch.models.mim_vit import fuse_params, mim_forward
from ofb_tpu_torch.models.vit import ModelCfg, ViT, vit_forward
from test_torch_port_export import converged_pair
from test_torch_port_from_jax import TINY, np_tree

torch.set_num_threads(1)
JAX_NAMES = [n for n in JR.list_models() if not n.startswith("swin")]
SWIN = [n for n in JR.list_models() if n.startswith("swin")]


def test_the_registries_hold_the_same_names():
    assert len(JAX_NAMES) == 50 and len(SWIN) == 6
    assert R.list_models() == sorted(JAX_NAMES + SWIN)


@pytest.mark.parametrize("name", JAX_NAMES)
def test_configs_match_jax(name):
    jb = JR.create_model(name)
    pb = R.create_model(name, device="cpu")
    want = dataclasses.asdict(jb.cfg)
    assert want["remat"] is False
    assert dataclasses.asdict(pb.cfg) == want
    assert pb.kind == jb.kind
    if jb.kind == "mim":
        assert pb.space.blocks[0].attn.head_list == \
            jb.space.blocks[0].attn.head_list
    # the same default class count, and the same config for another count
    jb, pb = JR.create_model(name, num_classes=7), R.create_model(
        name, device="cpu", num_classes=7)
    assert pb.cfg.num_classes == jb.cfg.num_classes == 7


@pytest.mark.parametrize("name", SWIN)
def test_swin_names_raise_naming_the_item(name):
    # the Swin family is ported: each name builds the JAX package's config
    jb = JR.create_model(name)
    pb = R.create_model(name, device="cpu")
    assert dataclasses.asdict(pb.cfg) == dataclasses.asdict(jb.cfg)
    assert pb.kind == jb.kind


def test_registry_shapes_of_the_new_family():
    cases = {"vit_huge_patch14_224": (257, 80, 32),
             "vit_huge_patch14_384": (730, 80, 32),
             "vit_large_patch16_384": (577, 64, 24),
             "vit_small_patch16_224": (197, 96, 8),
             "vit_base_patch32_224": (50, 64, 12),
             "vit_base_patch32_384": (145, 64, 12)}
    for name, (n, d, depth) in cases.items():
        cfg = R.create_model(name, device="cpu").cfg
        assert (cfg.num_patches + cfg.num_tokens, cfg.hd, cfg.depth) == \
            (n, d, depth), name
    in21k = R.create_model("vit_large_patch16_224_in21k", device="cpu").cfg
    assert in21k.representation_size == 1024 and in21k.num_classes == 21843
    assert R.create_model("vit_base_patch16_224_miil",
                          device="cpu").cfg.qkv_bias is False


# ---------------------------------------------------------------------------
# representation_size: the in21k pre-logits
# ---------------------------------------------------------------------------

REP = dict(TINY, representation_size=32, num_classes=11)


def _loss_and_grads_jax(tree, x, cfg):
    def loss(p):
        logits = jvit.vit_forward(p, x, cfg, compute_dtype=jnp.float32)
        return jnp.sum(logits * jnp.arange(logits.shape[-1]) / 10.0), logits
    (l, logits), g = jax.value_and_grad(loss, has_aux=True)(tree)
    return np.asarray(logits), flatten_from_jax(np_tree(g))


def close(got, want, name=""):
    scale = float(np.abs(want).max()) + 1e-30
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=name)


@pytest.mark.parametrize("kw", [dict(REP), dict(REP, distilled=True)])
def test_pre_logits_forward_and_gradients_match_jax(kw):
    jcfg = jvit.ModelCfg(**kw)
    tree = jvit.init_vit_params(jax.random.PRNGKey(1), jcfg)
    # biases that are not zero, so the pre-logits bias matters
    rng = np.random.default_rng(2)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.normal(0, 0.05, a.shape), a.dtype)
        if path[-1].key == "bias" else a, tree)
    assert ("pre_logits" in tree) == (not jcfg.distilled)
    cfg = ModelCfg(**kw)
    assert cfg.pre_logits == (not cfg.distilled)
    params = load_from_jax(ViT(cfg), np_tree(tree))
    assert hasattr(params, "pre_logits") == cfg.pre_logits
    x = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    logits = vit_forward(params, xt, cfg, compute_dtype=torch.float32)
    if cfg.distilled:
        want = jvit.vit_forward(tree, x, jcfg, compute_dtype=jnp.float32)
        close(logits.detach().numpy(), np.asarray(want))
        return
    (logits * torch.arange(11) / 10.0).sum().backward()
    jlogits, jgrads = _loss_and_grads_jax(tree, x, jcfg)
    close(logits.detach().numpy(), jlogits, "logits")
    grads = {n: p.grad.numpy() for n, p in params.named_parameters()}
    assert set(grads) == set(jgrads)
    assert "pre_logits.weight" in grads
    for n, g in jgrads.items():
        close(grads[n], g, n)


def test_pre_logits_round_trip_through_to_jax():
    cfg = ModelCfg(**REP)
    params = ViT(cfg, generator=torch.Generator().manual_seed(3))
    tree = to_jax(params)
    assert tree["pre_logits"]["kernel"].shape == (32, 32)
    assert tree["head"]["kernel"].shape == (32, 11)
    jcfg = jvit.ModelCfg(**REP)
    jtree = jvit.init_vit_params(jax.random.PRNGKey(0), jcfg)
    assert jax.tree_util.tree_structure(np_tree(jtree)) == \
        jax.tree_util.tree_structure(tree)
    back = load_from_jax(ViT(cfg), tree)
    for (n, a), (_, b) in zip(params.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), n
    # JAX runs the port's weights to the port's logits
    x = np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    close(vit_forward(params, torch.from_numpy(x), cfg,
                      compute_dtype=torch.float32).detach().numpy(),
          np.asarray(jvit.vit_forward(tree, x, jcfg,
                                      compute_dtype=jnp.float32)))


# ---------------------------------------------------------------------------
# qkv_bias=False (MIIL) through the search lifecycle
# ---------------------------------------------------------------------------

def test_a_supernet_without_qkv_bias_matches_jax():
    cfg_kw = dict(TINY, num_heads=4, depth=2, qkv_bias=False)
    (jcfg, jspace, jp, ja, jarch), (cfg, space, params, alphas, arch) = \
        converged_pair(cfg_kw, [((0, 3), 4), ((1, 5), 1)], seed=2)
    assert "bias" not in jp["blocks"][0]["attn"]["qkv"]
    assert params.blocks[0].attn.qkv.bias is None
    x = np.random.default_rng(5).uniform(0, 1, (3, 32, 32, 3)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    kw = dict(train=False, use_mim=False)
    jgated = jmim.mim_forward(jp, ja, jarch, x, jcfg, jspace,
                              compute_dtype=jnp.float32, **kw).logits
    with torch.no_grad():
        gated = mim_forward(params, alphas, arch, xt, cfg, space,
                            compute_dtype=torch.float32, **kw).logits
    np.testing.assert_allclose(gated.numpy(), np.asarray(jgated), atol=2e-4,
                               rtol=1e-4)
    fused, farch = fuse_params(params, arch, space, cfg)
    jfused, jfarch = jmim.fuse_params(jp, jarch, jspace, jcfg)
    want = flatten_from_jax(np_tree(jfused))
    for n, p in fused.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                   atol=0, err_msg=n)
    with torch.no_grad():
        sup = mim_forward(fused, alphas, farch, xt, cfg, space, fused=True,
                          compute_dtype=torch.float32, **kw).logits
    np.testing.assert_allclose(sup.numpy(), np.asarray(jgated), atol=2e-4,
                               rtol=1e-4)
    dense, dcfg, _ = export_subnet(params, arch, space, cfg)
    # JAX's export_subnet reads a qkv bias (KeyError without one): export
    # the same tree with zero qkv biases, then drop them
    with pytest.raises(KeyError, match="bias"):
        JE.export_subnet(jp, jarch, jspace, jcfg)
    jp0 = dict(jp, blocks=[
        dict(b, attn=dict(b["attn"], qkv=dict(
            b["attn"]["qkv"],
            bias=jnp.zeros(b["attn"]["qkv"]["kernel"].shape[1]))))
        for b in jp["blocks"]])
    jdense, jdcfg, _ = JE.export_subnet(jp0, jarch, jspace, jcfg)
    for b in jdense["blocks"]:
        assert not np.asarray(b["attn"]["qkv"].pop("bias")).any()
    assert dcfg.qkv_bias is False and dcfg.block_overrides == \
        jdcfg.block_overrides
    want = flatten_from_jax(np_tree(jdense))
    got = dict(dense.named_parameters())
    assert set(got) == set(want)
    assert not any(n.endswith("qkv.bias") for n in got)
    for n, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                   atol=0, err_msg=n)
    with torch.no_grad():
        sliced = vit_forward(dense, xt, dcfg, compute_dtype=torch.float32)
    np.testing.assert_allclose(sliced.numpy(), np.asarray(jgated),
                               atol=2e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# a patch size that does not divide the image
# ---------------------------------------------------------------------------

def test_a_patch_that_does_not_divide_the_image_matches_jax():
    kw = dict(TINY, img_size=38, patch_size=7)      # 5 x 5 patches, 3 px over
    jcfg, cfg = jvit.ModelCfg(**kw), ModelCfg(**kw)
    assert cfg.num_patches == jcfg.num_patches == 25
    tree = jvit.init_vit_params(jax.random.PRNGKey(6), jcfg)
    params = load_from_jax(ViT(cfg), np_tree(tree))
    assert params.pos_embed.shape == (1, 26, 32)
    x = np.random.default_rng(7).uniform(0, 1, (2, 38, 38, 3)).astype(
        np.float32)
    close(vit_forward(params, torch.from_numpy(x), cfg,
                      compute_dtype=torch.float32).detach().numpy(),
          np.asarray(jvit.vit_forward(tree, x, jcfg,
                                      compute_dtype=jnp.float32)))
    # the pixels past the last whole patch change nothing
    y = x.copy()
    y[:, 35:] = 0.0
    y[:, :, 35:] = 1.0
    torch.testing.assert_close(
        vit_forward(params, torch.from_numpy(y), cfg,
                    compute_dtype=torch.float32),
        vit_forward(params, torch.from_numpy(x), cfg,
                    compute_dtype=torch.float32), rtol=0, atol=0)
    # ViT-H/14 at 384: a 224 checkpoint's 16 x 16 grid resized to 27 x 27
    huge = R.create_model("vit_huge_patch14_384", device="cpu").cfg
    assert (huge.grid, huge.num_patches) == (27, 729)
    pe = np.random.default_rng(8).normal(0, 1, (1, 257, 16)).astype(
        np.float32)
    want = np.asarray(JP.interpolate_pos_embed(jnp.asarray(pe),
                                               huge.num_patches))
    got = P.interpolate_pos_embed(torch.from_numpy(pe), huge.num_patches)
    assert got.shape == want.shape == (1, 730, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# register_model
# ---------------------------------------------------------------------------

def test_a_registered_factory_is_listed_and_created(monkeypatch):
    """`register_model` as the JAX package's: the decorated factory is
    listed under its name and `create_model` calls it (the port's with the
    resolved device and the caller's keywords). Each registry is a copy
    for this test, so no other test sees the name."""
    monkeypatch.setattr(JR, "_REGISTRY", dict(JR._REGISTRY))
    monkeypatch.setattr(R, "_REGISTRY", dict(R._REGISTRY))
    kw = dict(TINY, num_classes=5)

    def tiny_registered_vit(num_classes=kw["num_classes"]):
        return dict(kw, num_classes=num_classes)

    @JR.register_model
    def jax_side(**over):
        return JR.ModelBundle(name="tiny_registered_vit",
                              cfg=jvit.ModelCfg(**tiny_registered_vit(
                                  **over)), kind="dense")

    @R.register_model
    def port_side(*, device, **over):
        return R.ModelBundle(name="tiny_registered_vit",
                             cfg=ModelCfg(**tiny_registered_vit(**over)),
                             space=None, device=device, kind="dense")

    assert jax_side is JR._REGISTRY["jax_side"]
    assert port_side is R._REGISTRY["port_side"]
    assert "jax_side" in JR.list_models() and "port_side" in R.list_models()
    assert R.list_models() == sorted(JAX_NAMES + SWIN + ["port_side"])
    for over in ({}, {"num_classes": 3}):
        jb = JR.create_model("jax_side", **over)
        pb = R.create_model("port_side", device="cpu", **over)
        assert dataclasses.asdict(pb.cfg) == dataclasses.asdict(jb.cfg)
        assert pb.device == torch.device("cpu") and pb.kind == jb.kind
    vit = pb.init(0)
    assert isinstance(vit, ViT) and vit.head.weight.shape[0] == 3
    with pytest.raises(KeyError, match="unknown model"):
        R.create_model("jax_side", device="cpu")
