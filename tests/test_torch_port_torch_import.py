"""The port's timm state-dict import (ofb_tpu_torch/models/torch_import.py)
against ofb_tpu/models/torch_import.py on the CPU:

* JAX's `params_to_torch_state_dict` of a JAX init loads into the port
  equal (exactly) to what `from_jax.py` makes of the same params, for the
  supernet and a dense (distilled) ViT;
* the keys the port takes are JAX's `_consumed_keys`, and `strict` reports
  the same unconsumed keys;
* a pos-embed of another grid is resized as JAX resizes it (atol 1e-5, the
  export test's tolerance for the resize), a head of another class count
  stays at init;
* the port's `params_to_torch_state_dict` round-trips and equals JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from ofb_tpu.models import torch_import as JT
from ofb_tpu.models import vit as jvit
from ofb_tpu_torch.models import torch_import as T
from ofb_tpu_torch.models.from_jax import flatten_from_jax, load_from_jax
from ofb_tpu_torch.models.mim_vit import MimViT
from ofb_tpu_torch.models.search_space import SearchSpace
from ofb_tpu_torch.models.vit import ModelCfg, ViT
from test_torch_port_from_jax import TINY, jax_supernet, np_tree, port_supernet

torch.set_num_threads(1)


def fresh_supernet(seed=42):
    cfg = ModelCfg(**TINY)
    space = SearchSpace.build(cfg.embed_dim, cfg.depth, cfg.num_heads,
                              cfg.hidden, cfg.num_patches, patch_search=True)
    return cfg, MimViT(cfg, space, generator=torch.Generator()
                       .manual_seed(seed))


def test_jax_state_dict_loads_like_from_jax():
    _, _, jp, ja, jarch = jax_supernet(TINY, seed=3)
    sd = JT.params_to_torch_state_dict(np_tree(jp))
    cfg, params = fresh_supernet()
    T.torch_state_dict_to_params(sd, cfg, params, strict=True)
    _, _, want, _, _ = port_supernet(TINY, jp, ja, jarch)
    got, ref = dict(params.named_parameters()), \
        dict(want.named_parameters())
    for n in sd:
        np.testing.assert_array_equal(got[n].detach().numpy(),
                                      ref[n].detach().numpy(), err_msg=n)
    # what a timm checkpoint does not hold (the search scores, the decoder)
    # stays at init
    untouched = set(got) - set(sd)
    assert untouched and all("score" in n or "decoder" in n
                             for n in untouched)
    # the same key set as JAX's export, and every key is consumed
    assert set(sd) <= JT._consumed_keys(TINY["depth"])


def test_dense_distilled_vit_loads_like_from_jax():
    kw = dict(TINY, distilled=True)
    jcfg = jvit.ModelCfg(**kw)
    jp = np_tree(jvit.init_vit_params(jax.random.PRNGKey(5), jcfg))
    sd = JT.params_to_torch_state_dict(jp)
    assert "dist_token" in sd and "head_dist.weight" in sd
    cfg = ModelCfg(**kw)
    params = T.torch_state_dict_to_params(sd, cfg, ViT(cfg), strict=True)
    want = flatten_from_jax(jp)
    for n, p in params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)
    # the port's export is JAX's
    back = T.params_to_torch_state_dict(params)
    assert set(back) == set(sd)
    for n in sd:
        np.testing.assert_array_equal(back[n], np.asarray(sd[n]), err_msg=n)


def test_consumed_keys_and_strict_report_match():
    for depth in (1, 2, 12):
        assert T._consumed_keys(depth) == JT._consumed_keys(depth)
    _, _, jp, _, _ = jax_supernet(TINY)
    sd = JT.params_to_torch_state_dict(np_tree(jp))
    sd["pre_logits.fc.weight"] = np.zeros((4, 4), np.float32)  # ignored
    sd["fc_norm.weight"] = np.zeros(4, np.float32)
    sd["blocks.9.attn.qkv.weight"] = np.zeros((4, 4), np.float32)
    jcfg = jvit.ModelCfg(**TINY)
    with pytest.raises(KeyError) as jerr:
        JT.torch_state_dict_to_params(sd, jcfg, np_tree(jp), strict=True)
    cfg, params = fresh_supernet()
    with pytest.raises(KeyError) as perr:
        T.torch_state_dict_to_params(sd, cfg, params, strict=True)
    assert str(perr.value) == str(jerr.value)
    assert "fc_norm.weight" in str(perr.value)
    # without strict the extra keys are skipped
    T.torch_state_dict_to_params(sd, cfg, params)


def test_pos_embed_resize_and_head_mismatch_match_jax():
    """A 224-pixel checkpoint (14 x 14 grid, 1000 classes) onto a 32-pixel
    model with 16 classes: the pos-embed resized 14 -> 4 as JAX does, the
    head kept at init."""
    big = dict(TINY, img_size=112, num_classes=1000)
    jbig = np_tree(jvit.init_vit_params(jax.random.PRNGKey(8),
                                        jvit.ModelCfg(**big)))
    sd = JT.params_to_torch_state_dict(jbig)
    jcfg = jvit.ModelCfg(**TINY)
    jsmall = np_tree(jvit.init_vit_params(jax.random.PRNGKey(9), jcfg))
    jout = np_tree(JT.torch_state_dict_to_params(sd, jcfg, jsmall))
    cfg = ModelCfg(**TINY)
    params = load_from_jax(ViT(cfg), jsmall)
    T.torch_state_dict_to_params(sd, cfg, params)
    want = flatten_from_jax(jout)
    for n, p in params.named_parameters():
        tol = 1e-5 if n == "pos_embed" else 0
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=tol, err_msg=n)
    assert params.pos_embed.shape == (1, cfg.num_patches + 1,
                                      cfg.embed_dim)
    np.testing.assert_array_equal(params.head.weight.detach().numpy(),
                                  flatten_from_jax(jsmall)["head.weight"])
    # a pos-embed of another width stays at init
    sd["pos_embed"] = np.zeros((1, 197, 48), np.float32)
    before = params.pos_embed.detach().clone()
    T.torch_state_dict_to_params(sd, cfg, params)
    assert torch.equal(params.pos_embed.detach(), before)


def test_round_trip_through_the_port():
    cfg, src = fresh_supernet(seed=1)
    sd = T.params_to_torch_state_dict(src)
    assert set(sd) == {n for n, _ in src.named_parameters()
                       if "score" not in n and "decoder" not in n}
    cfg, dst = fresh_supernet(seed=2)
    T.torch_state_dict_to_params(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg, dst,
        strict=True)
    again = T.params_to_torch_state_dict(dst)
    for n in sd:
        np.testing.assert_array_equal(again[n], sd[n], err_msg=n)
    # a tensor of another shape under a taken key raises
    sd["blocks.0.attn.qkv.weight"] = sd["blocks.0.attn.qkv.weight"][:5]
    with pytest.raises(ValueError, match="qkv"):
        T.torch_state_dict_to_params(sd, cfg, dst)
