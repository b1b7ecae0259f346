"""(a) The port's search space equals the JAX package's: ratio grids, mask
banks, cell sizes and the initial ArchState, for the DeiT supernets."""

import numpy as np
import pytest
import torch

from ofb_tpu.models import registry as jreg
from ofb_tpu.models import search_space as jss
from ofb_tpu_torch.models import search_space as ss
from ofb_tpu_torch.models.from_jax import arch_to_numpy
from ofb_tpu_torch.models.registry import create_model

torch.set_num_threads(1)

NAMES = ["deit_tiny_patch16_224_mim", "deit_small_patch16_224_mim",
         "deit_base_patch16_224_mim"]


@pytest.mark.parametrize("dim", [16, 24, 64, 192, 384, 768, 1536, 3072])
def test_ratio_grids_equal(dim):
    for name in ("embed_ratio_grid", "qkv_channel_grid", "mlp_hidden_grid"):
        assert getattr(ss, name)(dim) == getattr(jss, name)(dim), name
    assert ss.head_num_grid(dim // 8) == jss.head_num_grid(dim // 8)
    assert ss.patch_ratio_grid() == jss.patch_ratio_grid()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kw", [{}, {"head_search": True},
                                {"channel_search": True},
                                {"attn_search": False, "embed_search": False}])
def test_space_banks_and_arch_equal(name, kw):
    mine = create_model(name, device="cpu", **kw)
    theirs = jreg.create_model(name, **kw)
    assert mine.cfg.embed_dim == theirs.cfg.embed_dim
    assert mine.cfg.num_patches == theirs.cfg.num_patches
    a, b = mine.space, theirs.space
    for x, y in [(a.embed, b.embed), (a.patch, b.patch)] + [
            (p.mlp, q.mlp) for p, q in zip(a.blocks, b.blocks)]:
        assert x.ratios == y.ratios and x.searchable == y.searchable
        np.testing.assert_array_equal(x.cell_sizes, y.cell_sizes)
    np.testing.assert_array_equal(a.embed.mask_bank, b.embed.mask_bank)
    assert len(a.blocks) == len(b.blocks) == 12
    for p, q in zip(a.blocks, b.blocks):
        assert (p.attn.head_list, p.attn.chan_ratios, p.attn.searchable) == \
            (q.attn.head_list, q.attn.chan_ratios, q.attn.searchable)
        np.testing.assert_array_equal(p.attn.mask_bank, q.attn.mask_bank)
        np.testing.assert_array_equal(p.attn.cell_sizes, q.attn.cell_sizes)
        np.testing.assert_array_equal(p.mlp.mask_bank, q.mlp.mask_bank)

    arch_mine = arch_to_numpy(ss.ArchState.create(a))
    arch_theirs = arch_to_numpy(jss.ArchState.create(b))
    assert set(arch_mine) == set(arch_theirs)
    for k, v in arch_theirs.items():
        assert arch_mine[k].dtype == v.dtype, k
        np.testing.assert_array_equal(arch_mine[k], v, err_msg=k)


def test_arch_state_moves_between_devices_and_space_tensors():
    space = create_model(NAMES[0], device="cpu").space
    arch = ss.ArchState.create(space).to("cpu")
    assert arch.blocks[3].attn.scale.item() == pytest.approx(64 ** -0.5)
    st = ss.space_tensors(space, torch.device("cpu"))
    assert st is ss.space_tensors(space, torch.device("cpu"))   # built once
    np.testing.assert_array_equal(st.attn_bank.numpy(),
                                  space.blocks[0].attn.mask_bank)
    np.testing.assert_array_equal(st.patch_sizes.numpy(),
                                  space.patch.cell_sizes)
