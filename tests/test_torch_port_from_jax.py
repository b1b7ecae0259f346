"""Port test support, and the round trip of weights and state between the
JAX package and the port (ofb_tpu_torch/models/from_jax.py).

The helpers here build a JAX supernet from a seed and the port's twin of it
from the same weights; the other `test_torch_port_*` files import them.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.models import mim_vit as jmim
from ofb_tpu.models import search_space as jss
from ofb_tpu.models import vit as jvit
from ofb_tpu.ops import pmim as jpmim
from ofb_tpu_torch.models.from_jax import (arch_from_jax, arch_to_numpy,
                                           flatten_from_jax, load_from_jax,
                                           to_jax)
from ofb_tpu_torch.models.mim_vit import Alphas, MimViT
from ofb_tpu_torch.models.search_space import SearchSpace
from ofb_tpu_torch.models.vit import ModelCfg

torch.set_num_threads(1)

# bench.py's tiny config, no stochastic depth (randomness never crosses
# between the frameworks)
TINY = dict(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2,
            num_heads=2, mlp_ratio=2.0, drop_path_rate=0.0)
# deit_small widths (D 384, 6 x 64 heads, MLP 1536, 224², patch 16), depth 1
DEIT_S1 = dict(img_size=224, patch_size=16, num_classes=1000, embed_dim=384,
               depth=1, num_heads=6, mlp_ratio=4.0, drop_path_rate=0.0)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_supernet(cfg_kw, seed=0):
    """(cfg, space, params, alphas, arch) of the JAX package."""
    cfg = jvit.ModelCfg(**cfg_kw)
    space = jss.SearchSpace.build(cfg.embed_dim, cfg.depth, cfg.num_heads,
                                  cfg.hidden, cfg.num_patches,
                                  patch_search=True)
    kp, ka = jax.random.split(jax.random.PRNGKey(seed))
    return (cfg, space, jmim.init_mim_params(kp, cfg, space),
            jmim.init_alphas(ka, space), jss.ArchState.create(space))


def port_supernet(cfg_kw, jparams, jalphas, jarch):
    """The port's (cfg, space, params, alphas, arch) holding the JAX
    weights and state, on the CPU."""
    cfg = ModelCfg(**cfg_kw)
    space = SearchSpace.build(cfg.embed_dim, cfg.depth, cfg.num_heads,
                              cfg.hidden, cfg.num_patches, patch_search=True)
    params = load_from_jax(MimViT(cfg, space), np_tree(jparams))
    alphas = load_from_jax(Alphas(space), np_tree(jalphas))
    return cfg, space, params, alphas, arch_from_jax(jarch)


def pruned_arch(jarch):
    """A JAX ArchState after some prune events: a killed embed cell and
    dead embed channels, a killed attention cell and dead qkv channels in
    block 0, a finished MLP in block 1 (its score is then the gate)."""
    e = jarch.embed
    hm = np.asarray(e.hard_mask).copy()
    hm[-4:] = 0.0
    embed = e.replace(switch=e.switch.at[0].set(False),
                      hard_mask=jnp.asarray(hm))
    b0, b1 = jarch.blocks[0], jarch.blocks[1]
    ahm = np.asarray(b0.attn.hard_mask).copy()
    ahm[1, -4:] = 0.0
    b0 = b0.replace(attn=b0.attn.replace(
        switch=b0.attn.switch.at[0, 0].set(False),
        hard_mask=jnp.asarray(ahm)))
    b1 = b1.replace(mlp=b1.mlp.replace(finished=jnp.asarray(True)))
    return jarch.replace(embed=embed, blocks=(b0, b1) + jarch.blocks[2:])


def jax_token_mask(rng_fwd, cfg, batch, keep_ratio):
    """The PMIM mask JAX's mim_forward draws from `rng_fwd`."""
    r = jax.random.split(rng_fwd, cfg.depth + 3)[-1]
    L = cfg.num_patches
    kc = jnp.floor(L * jnp.asarray(keep_ratio, jnp.float32)).astype(jnp.int32)
    return np.array(jpmim.random_token_mask(r, batch, L, kc))


# ---------------------------------------------------------------------------
# tests of from_jax itself
# ---------------------------------------------------------------------------

def test_params_round_trip_and_layouts():
    _, _, jp, ja, jarch = jax_supernet(TINY)
    _, _, params, alphas, _ = port_supernet(TINY, jp, ja, jarch)
    # layouts: Linear (out, in), conv OIHW, LayerNorm weight
    blk = jp["blocks"][0]
    def arr(p):
        return p.detach().numpy()

    np.testing.assert_array_equal(arr(params.blocks[0].attn.qkv.weight),
                                  np.asarray(blk["attn"]["qkv"]["kernel"]).T)
    np.testing.assert_array_equal(
        arr(params.patch_embed.proj.weight),
        np.asarray(jp["patch_embed"]["proj"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        arr(params.decoder.conv.weight)[:, :, 0, 0],
        np.asarray(jp["decoder"]["conv"]["kernel"])[0, 0].T)
    np.testing.assert_array_equal(arr(params.blocks[1].norm2.weight),
                                  np.asarray(jp["blocks"][1]["norm2"]["scale"]))
    # every leaf, there and back
    for tree, mod in ((jp, params), (ja, alphas)):
        back = to_jax(mod)
        ja_leaves = jax.tree_util.tree_leaves_with_path(np_tree(tree))
        assert len(ja_leaves) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in ja_leaves:
            node = back
            for k in path:
                node = node[k.key if hasattr(k, "key") else k.idx]
            np.testing.assert_array_equal(node, leaf)


def test_arch_state_round_trip():
    _, _, _, _, jarch = jax_supernet(TINY)
    jarch = pruned_arch(jarch)
    arch = arch_from_jax(jarch)
    mine, theirs = arch_to_numpy(arch), arch_to_numpy(jarch)
    assert set(mine) == set(theirs)
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_flatten_skips_masked_leaves_and_checks_names():
    _, _, jp, _, _ = jax_supernet(TINY)
    flat = flatten_from_jax({"a": {"kernel": np.ones((2, 3))}, "b": None})
    assert list(flat) == ["a.weight"] and flat["a.weight"].shape == (3, 2)
    cfg = ModelCfg(**TINY)
    space = SearchSpace.build(32, 2, 2, cfg.hidden, cfg.num_patches)
    tree = np_tree(jp)
    del tree["mask_token"]
    with pytest.raises(KeyError):
        load_from_jax(MimViT(cfg, space), tree)


# ---------------------------------------------------------------------------
# (i) import hygiene and the default device
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ofb_tpu")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((ROOT / "ofb_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{f.relative_to(ROOT)} imports {name}"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from ofb_tpu_torch.config import SearchConfig
    from ofb_tpu_torch.core.optim import build_search_optimizer
    from ofb_tpu_torch.core.steps import make_search_step
    from ofb_tpu_torch.models.registry import create_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        create_model("deit_small_patch16_224_mim")
    scfg = SearchConfig().resolve(1)
    tx, _ = build_search_optimizer(scfg.optim_param, scfg.optim_arch,
                                   scfg.optim_decoder, scfg.schedule,
                                   total_steps=10, steps_per_epoch=5)
    bundle = create_model("deit_tiny_patch16_224_mim", device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        make_search_step(bundle.space, bundle.cfg, scfg, tx)
    assert bundle.device.type == "cpu"


def test_optimizer_leaf_names_map_both_ways():
    """JAX optimizer paths (`0.` params, `1.` alphas) against the port's
    leaf names, on every leaf of the supernet."""
    from ofb_tpu.core import optim as JO
    from ofb_tpu_torch.core.optim import named_leaves
    from ofb_tpu_torch.models.from_jax import jax_path, leaf_name
    _, _, jp, ja, jarch = jax_supernet(TINY)
    _, _, params, alphas, _ = port_supernet(TINY, jp, ja, jarch)
    paths = [JO._path_str(p) for p, _ in
             jax.tree_util.tree_leaves_with_path((jp, ja))]
    leaves = named_leaves(params, alphas)
    assert [leaf_name(p) for p in paths] == list(
        flatten_from_jax(np_tree(jp))) + [
        "alphas." + n for n in flatten_from_jax(np_tree(ja))]
    assert {leaf_name(p) for p in paths} == set(leaves)
    for p in paths:
        name = leaf_name(p)
        assert jax_path(name, leaves[name].dim()) == p
    assert leaf_name("0.patch_embed.score") == "patch_embed.score"
    assert leaf_name("1.blocks.3.attn") == "alphas.blocks.3.attn"
    assert leaf_name("0.blocks.1.norm2.scale") == "blocks.1.norm2.weight"
    assert leaf_name("blocks.0.attn.qkv.kernel") == "blocks.0.attn.qkv.weight"
    assert jax_path("norm.weight", 1, pair=False) == "norm.scale"


def test_zero_adam_moments_matches_on_jax_predicate():
    """The same prune event's moment reset in both packages: JAX's
    predicate on its paths, the port's on the mapped names."""
    from ofb_tpu.config import OptimFamilyConfig as JFam
    from ofb_tpu.config import ScheduleConfig as JSched
    from ofb_tpu.core import optim as JO
    from ofb_tpu_torch.config import OptimFamilyConfig, ScheduleConfig
    from ofb_tpu_torch.core import optim as O
    from ofb_tpu_torch.models.from_jax import leaf_name, moments_from_jax
    _, _, jp, ja, jarch = jax_supernet(TINY)
    _, _, params, alphas, _ = port_supernet(TINY, jp, ja, jarch)
    jtx, _ = JO.build_search_optimizer(JFam(lr=1e-3), JFam(lr=1e-2),
                                       JFam(lr=1e-3), JSched(),
                                       total_steps=10, steps_per_epoch=5)
    jopt = jax.tree_util.tree_map(jnp.ones_like, jtx.init((jp, ja)))
    tx, _ = O.build_search_optimizer(
        OptimFamilyConfig(lr=1e-3), OptimFamilyConfig(lr=1e-2),
        OptimFamilyConfig(lr=1e-3), ScheduleConfig(), total_steps=10,
        steps_per_epoch=5)
    opt = tx.init(O.named_leaves(params, alphas))
    for t in list(opt.mu.values()) + list(opt.nu.values()):
        t.fill_(1.0)
    opt.count = 1
    zero = ["1.patch", "1.blocks.1.attn", "0.blocks.1.attn.score",
            "0.patch_embed.score"]
    jopt = JO.zero_adam_moments(
        jopt, lambda path: any(path.startswith(z) for z in zero))
    names = {leaf_name(z) for z in zero}
    mu_objects = dict(opt.mu)
    assert O.zero_adam_moments(opt, lambda n: n in names) is opt
    want = moments_from_jax(jopt)
    assert opt.count == want["count"] == 1
    for which in ("mu", "nu"):
        got = getattr(opt, which)
        assert set(got) == set(want[which])
        for n, t in got.items():
            np.testing.assert_array_equal(t.numpy(), want[which][n], n)
            assert bool(t.any()) == (n not in names), n
    assert all(opt.mu[n] is t for n, t in mu_objects.items())


def test_new_entry_points_default_to_cuda(monkeypatch):
    from ofb_tpu_torch.core import steps as S
    from ofb_tpu_torch.core.lr_decay import build_finetune_optimizer
    from ofb_tpu_torch.models.registry import create_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        create_model("deit_small_patch16_224_finetune")
    bundle = create_model("deit_tiny_patch16_224", device="cpu")
    sup = create_model("deit_tiny_patch16_224_mim", device="cpu")
    tx = build_finetune_optimizer(torch.nn.Linear(2, 2),
                                  lr_schedule=lambda c: 1e-3)
    for make in (lambda **kw: S.make_train_step(bundle.cfg, tx,
                                                num_classes=1000, **kw),
                 lambda **kw: S.make_eval_step_dense(bundle.cfg, **kw),
                 lambda **kw: S.make_eval_step(sup.space, sup.cfg, **kw)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
        make(device="cpu")
