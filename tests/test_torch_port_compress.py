"""The compress state machine (ofb_tpu_torch/core/compress.py) against the
JAX package's, over several passes on crafted alphas.

Both sides start from the same supernet, the same scores (rounded to one
decimal, so the rankings are full of ties that only a stable sort breaks
alike) and optimizer states whose every moment is 1. Between passes the
test writes the same crafted alphas into both and moves w_p by the same
schedule. After every pass it compares the report (the very event strings),
every alpha, every leaf of the arch state, the scores and which moments
were zeroed. The decisions are float64 numpy on both sides from identical
fp32 inputs, so everything is compared exactly, except the rewritten
scores (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.config import OptimFamilyConfig as JFam
from ofb_tpu.config import ScheduleConfig as JSched
from ofb_tpu.core import compress as JC
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu.models import mim_vit as jmim
from ofb_tpu.models import search_space as jss
from ofb_tpu.models import vit as jvit
from ofb_tpu_torch.config import OptimFamilyConfig, ScheduleConfig
from ofb_tpu_torch.core import compress as C
from ofb_tpu_torch.core import optim as O
from ofb_tpu_torch.core import steps as S
from ofb_tpu_torch.models.from_jax import (arch_from_jax, arch_to_numpy,
                                           flatten_from_jax, load_from_jax,
                                           moments_from_jax)
from ofb_tpu_torch.models.mim_vit import Alphas, MimViT
from ofb_tpu_torch.models.search_space import SearchSpace
from ofb_tpu_torch.models.vit import ModelCfg
from test_torch_port_from_jax import TINY, np_tree

torch.set_num_threads(1)
# 4 heads of 8 channels: a (2, 7) attention cell grid (heads 2 | 4, channels
# 2..8), so that heads and channels can both be trimmed
TINY4 = dict(TINY, num_heads=4)


def optimizers():
    j = JO.build_search_optimizer(JFam(lr=1e-3), JFam(lr=1e-2), JFam(lr=1e-3),
                                  JSched(), total_steps=10, steps_per_epoch=5)
    p = O.build_search_optimizer(
        OptimFamilyConfig(lr=1e-3), OptimFamilyConfig(lr=1e-2),
        OptimFamilyConfig(lr=1e-3), ScheduleConfig(), total_steps=10,
        steps_per_epoch=5)
    return j[0], p[0]


class Pair:
    """The same search state in both packages."""

    def __init__(self, cfg_kw=TINY4, seed=0, **space_kw):
        space_kw.setdefault("patch_search", True)
        self.jcfg = jvit.ModelCfg(**cfg_kw)
        c = self.jcfg
        dims = (c.embed_dim, c.depth, c.num_heads, c.hidden, c.num_patches)
        self.jspace = jss.SearchSpace.build(*dims, **space_kw)
        kp, ka = jax.random.split(jax.random.PRNGKey(seed))
        jp = jmim.init_mim_params(kp, c, self.jspace)
        # ties in every ranking
        self.jp = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.round(a * 5) / 5
            if path[-1].key == "score" else a, jp)
        self.ja = jmim.init_alphas(ka, self.jspace)
        self.jarch = jss.ArchState.create(self.jspace)
        jtx, tx = optimizers()
        self.jopt = jax.tree_util.tree_map(
            lambda x: jnp.ones_like(x), jtx.init((self.jp, self.ja)))

        self.cfg = ModelCfg(**cfg_kw)
        self.space = SearchSpace.build(*dims, **space_kw)
        self.params = load_from_jax(MimViT(self.cfg, self.space),
                                    np_tree(self.jp))
        self.alphas = load_from_jax(Alphas(self.space), np_tree(self.ja))
        self.arch = arch_from_jax(self.jarch)
        self.opt = tx.init(O.named_leaves(self.params, self.alphas))
        for t in list(self.opt.mu.values()) + list(self.opt.nu.values()):
            t.fill_(1.0)
        self.opt.count = 1

    def craft(self, fn):
        """Rewrite the alphas of both sides: fn(numpy alphas tree)."""
        tree = jax.tree_util.tree_map(np.array, self.ja)
        fn(tree)
        self.ja = jax.tree_util.tree_map(jnp.asarray, tree)
        load_from_jax(self.alphas, tree)

    def remoment(self):
        self.jopt = jax.tree_util.tree_map(jnp.ones_like, self.jopt)
        for t in list(self.opt.mu.values()) + list(self.opt.nu.values()):
            t.fill_(1.0)

    def compress(self, thresh=0.2):
        self.jp, self.ja, self.jarch, self.jopt, jrep = JC.compress(
            self.jp, self.ja, self.jarch, self.jopt, self.jspace, thresh)
        ids = [id(t) for t in self.leaf_objects()]
        out = C.compress(self.params, self.alphas, self.arch, self.opt,
                         self.space, thresh)
        # in place: the same model, the same tensors
        assert out[0] is self.params and out[1] is self.alphas
        assert out[2] is self.arch and out[3] is self.opt
        assert ids == [id(t) for t in self.leaf_objects()]
        return jrep, out[4]

    def leaf_objects(self):
        leaves = list(O.named_leaves(self.params, self.alphas).values())
        arch = [self.arch.embed, self.arch.patch] + [
            m for b in self.arch.blocks for m in (b.attn, b.mlp)]
        return leaves + [t for m in arch for t in vars(m).values()] \
            + list(self.opt.mu.values()) + list(self.opt.nu.values())

    def check(self, jrep=None, rep=None):
        if jrep is not None:
            assert rep.events == jrep.events
            assert rep.execute_prune == jrep.execute_prune
            assert rep.finish_search == jrep.finish_search
        want = flatten_from_jax(np_tree(self.ja))
        for n, p in self.alphas.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), want[n], n)
        mine, theirs = arch_to_numpy(self.arch), arch_to_numpy(self.jarch)
        assert set(mine) == set(theirs)
        for k in theirs:
            assert mine[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
        want = flatten_from_jax(np_tree(self.jp))
        for n, p in self.params.named_parameters():
            if n.endswith("score"):
                np.testing.assert_allclose(p.detach().numpy(), want[n],
                                           rtol=1e-6, atol=0, err_msg=n)
        jm = moments_from_jax(self.jopt)
        assert jm["count"] == self.opt.count == 1      # the count stays
        zeroed = set()
        for which in ("mu", "nu"):
            assert set(jm[which]) == set(getattr(self.opt, which))
            for n, t in getattr(self.opt, which).items():
                np.testing.assert_array_equal(t.numpy(), jm[which][n], n)
                if not t.any():
                    zeroed.add(n)
        assert self.arch.all_finished == self.jarch.all_finished
        return zeroed


def low(a, idx):
    a[idx] = -8.0


def onehot(a, idx):
    a[...] = -8.0
    a[idx] = 8.0


def test_passes_of_kill_trim_converge_match_jax():
    pair = Pair()
    # pass 0: fresh uniform alphas kill nothing
    jrep, rep = pair.compress()
    assert rep.events == [] and not rep.execute_prune
    assert pair.check(jrep, rep) == set()

    # pass 1: trailing trims (embed, block 0 heads and channels), a kill in
    # the middle of block 1's MLP (no trim), two patch cells
    def craft1(t):
        low(t["embed"], slice(-3, None))
        low(t["blocks"][0]["attn"], (slice(None), slice(-2, None)))
        low(t["blocks"][1]["attn"], (1, slice(None)))
        low(t["blocks"][1]["mlp"], 2)
        low(t["blocks"][0]["mlp"], slice(-2, None))
        low(t["patch"], slice(0, 2))
    pair.craft(craft1)
    pair.jarch = JC.update_w_p(pair.jarch, 3.0, 20)
    C.update_w_p(pair.arch, 3.0, 20)
    jrep, rep = pair.compress()
    assert len(rep.events) == 6 and rep.execute_prune
    assert not any("converged" in e for e in rep.events)
    zeroed = pair.check(jrep, rep)
    assert zeroed == {"alphas.embed", "alphas.patch", "alphas.blocks.0.attn",
                      "alphas.blocks.1.attn", "alphas.blocks.0.mlp",
                      "alphas.blocks.1.mlp"}
    assert pair.arch.embed.hard_mask.sum() < 32           # trimmed
    assert pair.arch.blocks[1].mlp.hard_mask.sum() == 64  # killed, no trim
    assert bool(pair.arch.patch.pruned_once)

    # pass 2: convergence of the embed, block 0's attention and MLP and the
    # patch dimension, at another w_p (it enters the rewritten scores)
    def craft2(t):
        onehot(t["embed"], 4)
        onehot(t["blocks"][0]["attn"], (0, 2))
        onehot(t["blocks"][0]["mlp"], 1)
        onehot(t["patch"], 3)
    pair.craft(craft2)
    pair.remoment()
    pair.jarch = JC.sync_w_p(pair.jarch, 11.5, 20)
    C.sync_w_p(pair.arch, 11.5, 20)
    jrep, rep = pair.compress()
    assert sum("converged" in e for e in rep.events) == 4
    assert not rep.finish_search
    zeroed = pair.check(jrep, rep)
    assert zeroed == {"alphas.embed", "alphas.patch", "alphas.blocks.0.attn",
                      "alphas.blocks.0.mlp", "patch_embed.score",
                      "blocks.0.attn.score", "blocks.0.mlp.score"}
    a0 = pair.arch.blocks[0].attn
    chans = pair.space.blocks[0].attn.chan_counts[2]
    assert bool(a0.finished) and int(a0.head_alive) == 2
    assert a0.scale.item() == pytest.approx(chans ** -0.5)
    assert a0.hard_mask.sum() == 2 * chans
    assert int(pair.arch.blocks[1].attn.head_alive) == 2     # trimmed heads
    # a converged score is the linear gate: zero on dead channels
    sc = pair.params.patch_embed.score.detach()
    assert (sc[pair.arch.embed.hard_mask == 0] == 0).all()
    assert (sc[pair.arch.embed.hard_mask > 0] > 0).all()

    # pass 3: nothing left to do in the finished modules; w_p only moves
    # where the search goes on
    w_before = float(pair.arch.embed.w_p)
    pair.jarch = JC.update_w_p(pair.jarch, 15.0, 20)
    C.update_w_p(pair.arch, 15.0, 20)
    assert float(pair.arch.embed.w_p) == w_before
    assert float(pair.arch.blocks[1].mlp.w_p) != w_before
    pair.remoment()
    jrep, rep = pair.compress()
    assert rep.events == []
    assert pair.check(jrep, rep) == set()

    # decompress re-opens nothing here (every finished module has one cell)
    pair.jarch = JC.decompress(pair.jarch)
    assert C.decompress(pair.arch) is pair.arch
    pair.check()

    # pass 4: the rest converges, the search is finished
    def craft3(t):
        onehot(t["blocks"][1]["attn"], (0, 1))
        onehot(t["blocks"][1]["mlp"], 0)
    pair.craft(craft3)
    jrep, rep = pair.compress()
    assert rep.finish_search and pair.arch.all_finished
    pair.check(jrep, rep)


@pytest.mark.parametrize("space_kw", [dict(head_search=True),
                                      dict(channel_search=True),
                                      dict(attn_search=False),
                                      dict(embed_search=False,
                                           patch_search=False)],
                         ids=lambda kw: "-".join(kw))
def test_other_search_spaces_converge_like_jax(space_kw):
    """Broadcast score shapes ((H, 1) head search, (1, d) channel search)
    and modules that are not searched."""
    pair = Pair(seed=2, **space_kw)

    def craft(t):
        for b in t["blocks"]:
            onehot(b["attn"], tuple(0 for _ in b["attn"].shape))
            low(b["mlp"], slice(-1, None))
        onehot(t["embed"], 0)
    pair.craft(craft)
    jrep, rep = pair.compress()
    assert rep.execute_prune
    pair.check(jrep, rep)
    pair.craft(lambda t: [onehot(b["mlp"], 2) for b in t["blocks"]])
    jrep, rep = pair.compress()
    pair.check(jrep, rep)
    assert rep.finish_search == (not pair.space.patch.searchable)


def test_thresholds_and_numerical_guard():
    """`_kill_cells` on its edges: nothing under the threshold, the guard
    that keeps the best cell, ties at the threshold."""
    cases = [
        (np.array([0.1, 0.2, 0.3], np.float32), np.ones(3, bool), 0.2),
        (np.array([0.0, 0.0, 0.0], np.float32), np.ones(3, bool), 3.5),
        (np.array([5.0, -5.0, 0.0, 1.0], np.float32),
         np.array([True, True, False, True]), 0.2),
        (np.array([[1.0, -9.0], [-9.0, -9.0]], np.float32),
         np.ones((2, 2), bool), 0.2),
        (np.array([1.0], np.float32), np.ones(1, bool), 0.2),
    ]
    for alpha, switch, thresh in cases:
        a, b = C._kill_cells(alpha, switch, thresh), \
            JC._kill_cells(alpha, switch, thresh)
        assert (a.pruned, a.converged, a.killed) == \
            (b.pruned, b.converged, b.killed)
        if a.pruned:
            np.testing.assert_array_equal(a.new_switch, b.new_switch)
            np.testing.assert_array_equal(a.new_alpha, b.new_alpha)
    np.testing.assert_array_equal(
        C._masked_softmax_np(cases[2][0], cases[2][1]),
        JC._masked_softmax_np(cases[2][0], cases[2][1]))
    score = np.array([0.2, 0.4, 0.4, 0.2, 0.4], np.float32)
    hard = np.array([1, 1, 0, 1, 1], np.float32)
    for k in range(5):
        np.testing.assert_array_equal(C._topk_mask_1d(score, hard, k),
                                      JC._topk_mask_1d(score, hard, k))
    # ties break in index order
    np.testing.assert_array_equal(C._topk_mask_1d(score, hard, 2),
                                  [0, 1, 0, 0, 1])


def test_finish_singletons_and_decompress():
    pair = Pair(seed=3)
    e = pair.jarch.embed
    one = jnp.zeros_like(e.switch).at[2].set(True)
    b0 = pair.jarch.blocks[0]
    pair.jarch = pair.jarch.replace(
        embed=e.replace(switch=one),
        blocks=(b0.replace(mlp=b0.mlp.replace(finished=jnp.asarray(True))),)
        + pair.jarch.blocks[1:])
    pair.arch = arch_from_jax(pair.jarch)
    pair.jarch = JC._finish_singletons(pair.jarch, pair.jspace)
    assert C._finish_singletons(pair.arch, pair.space) is pair.arch
    assert bool(pair.arch.embed.finished)
    assert not bool(pair.arch.blocks[1].attn.finished)
    pair.check()
    # decompress re-opens the MLP (several cells), not the embed (one)
    pair.jarch = JC.decompress(pair.jarch)
    C.decompress(pair.arch)
    assert not bool(pair.arch.blocks[0].mlp.finished)
    assert bool(pair.arch.embed.finished)
    pair.check()


@pytest.mark.parametrize("frac", [0.0, 3.3, 20.0, 25.0])
def test_w_p_schedules_match(frac):
    pair = Pair(seed=4)
    b1 = pair.jarch.blocks[1]
    pair.jarch = pair.jarch.replace(blocks=(pair.jarch.blocks[0], b1.replace(
        attn=b1.attn.replace(finished=jnp.asarray(True),
                             w_p=jnp.asarray(0.5, jnp.float32)))))
    pair.arch = arch_from_jax(pair.jarch)
    assert S.w_p_schedule(frac, 20) == float(JS.w_p_schedule(frac, 20))
    pair.jarch = JC.sync_w_p(pair.jarch, frac, 20)
    C.sync_w_p(pair.arch, frac, 20)
    pair.check()
    assert float(pair.arch.blocks[1].attn.w_p) == 0.5
    pair.jarch = JC.update_w_p(pair.jarch, frac + 1.0, 20)
    C.update_w_p(pair.arch, frac + 1.0, 20)
    pair.check()


def test_fetch_host_is_one_copy_of_every_type():
    ts = [torch.tensor([True, False]), torch.tensor(3, dtype=torch.int32),
          torch.tensor([[0.25, -1.5]]), torch.tensor(0.99)]
    out = C.fetch_host(ts)
    assert [a.shape for a in out] == [(2,), (), (1, 2), ()]
    assert out[0].dtype == bool and out[0].tolist() == [True, False]
    assert int(out[1]) == 3 and out[2].tolist() == [[0.25, -1.5]]
    assert float(out[3]) == float(np.float32(0.99))
    assert C.fetch_host([]) == []


def test_swin_stage_embeds_are_left_out():
    pair = Pair(seed=5)
    space = SearchSpace(embed=pair.space.embed, blocks=pair.space.blocks,
                        patch=pair.space.patch,
                        stage_embeds=(pair.space.embed,))
    with pytest.raises(NotImplementedError):
        C.compress(pair.params, pair.alphas, pair.arch, None, space)
