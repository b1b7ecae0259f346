"""`export_subnet` (ofb_tpu_torch/core/export.py) and the pos-embed resize
(ofb_tpu_torch/models/pos_embed.py) against the JAX package's.

Export: from the same converged supernet, every tensor of the port's dense
model equals JAX's dense tree (the same slices of the same fused weights:
rtol 1e-6), `meta` and the dense config are equal, and on the port's side
gated supernet == fused supernet == sliced subnet (rtol 1e-4 / atol 2e-4,
the JAX package's own tolerance for this claim). Blocks converge to
different cells, so the subnet has mixed head geometry.

Pos-embed: the port writes JAX's resize out as per-axis weight matrices;
up- and down-sampling agree to atol 1e-5 (fp32 sums of at most 8 terms).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.core import compress as JC
from ofb_tpu.core import export as JE
from ofb_tpu.models import pos_embed as JP
from ofb_tpu.models import vit as jvit
from ofb_tpu_torch.core.export import export_subnet, exported_param_count
from ofb_tpu_torch.models import pos_embed as P
from ofb_tpu_torch.models.from_jax import flatten_from_jax, load_from_jax
from ofb_tpu_torch.models.mim_vit import fuse_params, mim_forward
from ofb_tpu_torch.models.vit import ViT, vit_forward
from test_torch_port_from_jax import (DEIT_S1, TINY, jax_supernet, np_tree,
                                      port_supernet)

torch.set_num_threads(1)
TINY4 = dict(TINY, num_heads=4, depth=3)
DEIT_S2 = dict(DEIT_S1, depth=2)


def converged_pair(cfg_kw, cells, seed=0, distilled=False):
    """Both packages' supernet after one compress pass that converges
    every module; `cells` gives (attn cell, mlp cell) per block."""
    cfg_kw = dict(cfg_kw, distilled=distilled)
    jcfg, jspace, jp, ja, jarch = jax_supernet(cfg_kw, seed)
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.normal(0, 0.02, a.shape), a.dtype)
        if path[-1].key == "bias" else a, jp)

    def onehot(shape, idx):
        a = np.full(shape, -8.0, np.float32)
        a[idx] = 8.0
        return jnp.asarray(a)

    ja = dict(ja)
    ja["embed"] = onehot(ja["embed"].shape, 5)
    ja["patch"] = onehot(ja["patch"].shape, 2)
    ja["blocks"] = [{"attn": onehot(b["attn"].shape, at),
                     "mlp": onehot(b["mlp"].shape, m)}
                    for b, (at, m) in zip(ja["blocks"], cells)]
    jp, ja, jarch, _, rep = JC.compress(jp, ja, jarch, None, jspace)
    assert rep.finish_search
    port = port_supernet(cfg_kw, jp, ja, jarch)
    return (jcfg, jspace, jp, ja, jarch), port


CASES = {
    "tiny4": (TINY4, [((0, 3), 4), ((1, 6), 0), ((1, 1), 6)], False),
    "tiny4_distilled": (TINY4, [((0, 0), 1), ((1, 2), 2), ((0, 5), 3)], True),
    # deit_small widths: 4 heads of 40 (8 * odd) and 2 heads of 32
    "deit_s2": (DEIT_S2, [((1, 3), 2), ((0, 2), 5)], False),
}


@pytest.mark.parametrize("case", CASES)
def test_export_tensors_meta_and_cfg_match_jax(case):
    cfg_kw, cells, distilled = CASES[case]
    (jcfg, jspace, jp, ja, jarch), (cfg, space, params, alphas, arch) = \
        converged_pair(cfg_kw, cells, distilled=distilled)
    jdense, jdcfg, jmeta = JE.export_subnet(jp, jarch, jspace, jcfg)
    dense, dcfg, meta = export_subnet(params, arch, space, cfg)
    want = flatten_from_jax(np_tree(jdense))
    got = dict(dense.named_parameters())
    assert set(got) == set(want)
    for n, p in got.items():
        assert tuple(p.shape) == want[n].shape, n
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                   atol=0, err_msg=n)
    assert meta == jmeta
    assert dataclasses.asdict(dcfg) == {
        k: v for k, v in dataclasses.asdict(jdcfg).items()
        if k in dataclasses.asdict(dcfg)}
    assert len(set(dcfg.block_overrides)) == len(cells)      # mixed geometry
    assert exported_param_count(dense) == JE.exported_param_count(jdense)
    assert exported_param_count(dense) < exported_param_count(params)
    # the JAX tree loads into a ViT built from the port's dense config
    again = load_from_jax(ViT(dcfg), np_tree(jdense))
    for n, p in again.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   got[n].detach().numpy(), rtol=1e-6)
    # the supernet handed in was not fused in place
    assert not bool(arch.fused)


@pytest.mark.parametrize("case", CASES)
def test_gated_equals_fused_equals_sliced(case):
    cfg_kw, cells, distilled = CASES[case]
    (jcfg, jspace, jp, ja, jarch), (cfg, space, params, alphas, arch) = \
        converged_pair(cfg_kw, cells, seed=1, distilled=distilled)
    x = np.random.default_rng(3).uniform(
        0, 1, (3, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    kw = dict(train=False, use_mim=False, compute_dtype=torch.float32)
    fused, farch = fuse_params(params, arch, space, cfg)
    dense, dcfg, _ = export_subnet(fused, farch, space, cfg, fuse=False)
    auto, _, _ = export_subnet(params, arch, space, cfg, fuse=True)
    for (n, a), (_, b) in zip(dense.named_parameters(),
                              auto.named_parameters()):
        assert torch.equal(a, b), n
    with torch.no_grad():
        gated = mim_forward(params, alphas, arch, xt, cfg, space, **kw).logits
        sup = mim_forward(fused, alphas, farch, xt, cfg, space, fused=True,
                          **kw).logits
        sliced = vit_forward(dense, xt, dcfg, compute_dtype=torch.float32)
    np.testing.assert_allclose(sup.numpy(), sliced.numpy(), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(gated.numpy(), sliced.numpy(), atol=2e-4,
                               rtol=1e-4)
    # and JAX's sliced subnet says the same
    jdense, jdcfg, _ = JE.export_subnet(jp, jarch, jspace, jcfg)
    jlogits = jvit.vit_forward(jdense, x, jdcfg, compute_dtype=jnp.float32)
    np.testing.assert_allclose(sliced.numpy(), np.asarray(jlogits),
                               atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("g_old,g_new,extra", [(14, 24, 1), (14, 7, 2),
                                               (4, 6, 1), (8, 8, 1),
                                               (12, 5, 1)])
def test_interpolate_pos_embed_matches(g_old, g_new, extra):
    rng = np.random.default_rng(g_old * g_new)
    pe = rng.normal(0, 0.02, (1, extra + g_old * g_old, 24)).astype(np.float32)
    want = np.asarray(JP.interpolate_pos_embed(jnp.asarray(pe), g_new * g_new,
                                               extra))
    got = P.interpolate_pos_embed(torch.from_numpy(pe), g_new * g_new, extra)
    assert tuple(got.shape) == want.shape == (1, extra + g_new * g_new, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:, :extra].numpy(), pe[:, :extra])
    if g_old == g_new:
        assert got.data_ptr() == torch.from_numpy(pe).data_ptr()


@pytest.mark.parametrize("cls_token", [False, True])
def test_sincos_tables_match(cls_token):
    want = JP.get_2d_sincos_pos_embed(32, 7, cls_token=cls_token,
                                      num_extra_tokens=2)
    got = P.get_2d_sincos_pos_embed(32, 7, cls_token=cls_token,
                                    num_extra_tokens=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        P.get_1d_sincos_pos_embed_from_grid(16, np.arange(5.0)),
        JP.get_1d_sincos_pos_embed_from_grid(16, np.arange(5.0)))
