"""fused_augment=True in the port's search and train steps, on the CPU.

A fused step takes uint8 staging batches and runs `apply_train_augment` on
the device before the forward. With the same `augment_draws` (one per
microbatch) and the same generator for the other draws (PMIM masks, Mixup),
it must equal the unfused step fed the images `apply_train_augment` made
from those draws: bit-identical metrics, weights, alphas and moments.
"""

import pytest
import torch

from ofb_tpu_torch.cli.common import tiny_bundle
from ofb_tpu_torch.config import MixupConfig, SearchConfig
from ofb_tpu_torch.core.lr_decay import build_finetune_optimizer
from ofb_tpu_torch.core.optim import build_search_optimizer, named_leaves
from ofb_tpu_torch.core.steps import (TrainState, make_search_step,
                                      make_train_step)
from ofb_tpu_torch.models.vit import ViT
from ofb_tpu_torch.ops.augment import apply_train_augment, draw_train_augment

torch.set_num_threads(1)
A, MB, S = 2, 4, 40


def batch(seed, **kw):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (A, MB, S, S, 3), generator=g,
                      dtype=torch.uint8)
    y = torch.randint(0, 10, (A, MB), generator=g)
    draws = [draw_train_augment(g, MB, S, 32, **kw) for _ in range(A)]
    ready = torch.stack([apply_train_augment(x[a], draws[a], out_size=32)
                         for a in range(A)])
    return x, y, draws, ready


def supernet_state():
    bundle = tiny_bundle(10, "cpu")
    params, alphas, arch = bundle.init(0)
    scfg = SearchConfig(accum_iter=A).resolve(1)
    tx, _ = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=100, steps_per_epoch=10, accum_iter=A)
    return bundle, scfg, tx, TrainState(0, params, alphas, arch,
                                        tx.init(named_leaves(params, alphas)))


def assert_same(a: TrainState, b: TrainState, ma, mb):
    assert set(ma) == set(mb)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for (n, p), (_, q) in zip(a.params.named_parameters(),
                              b.params.named_parameters()):
        assert torch.equal(p, q), n
    if a.alphas is not None:
        for (n, p), (_, q) in zip(a.alphas.named_parameters(),
                                  b.alphas.named_parameters()):
            assert torch.equal(p, q), n
    for n in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[n], b.opt_state.mu[n]), n
        assert torch.equal(a.opt_state.nu[n], b.opt_state.nu[n]), n


@pytest.mark.parametrize("phase", ["search", "postsearch"])
@pytest.mark.parametrize("randaug", [True, False])
def test_fused_search_step_equals_unfused(phase, randaug):
    kw = dict(use_randaug=randaug, re_prob=0.5, crop_scale=(0.3, 1.0),
              hflip=True)
    bundle, scfg, tx, fused_state = supernet_state()
    _, _, _, plain_state = supernet_state()
    common = dict(phase=phase, compute_dtype=torch.float32, device="cpu")
    fused = make_search_step(bundle.space, bundle.cfg, scfg, tx,
                             fused_augment=True, **kw, **common)
    plain = make_search_step(bundle.space, bundle.cfg, scfg, tx, **common)
    for k in range(2):
        x, y, draws, ready = batch(10 + k, **kw)
        fused_state, mf = fused(fused_state, x, y,
                                torch.Generator().manual_seed(k), 0.75,
                                augment_draws=draws)
        plain_state, mp = plain(plain_state, ready, y,
                                torch.Generator().manual_seed(k), 0.75)
        assert_same(fused_state, plain_state, mf, mp)
        assert all(torch.isfinite(v) for v in mf.values())


def test_fused_train_step_equals_unfused():
    bundle = tiny_bundle(10, "cpu")
    kw = dict(use_randaug=True, re_prob=0.25, crop_scale=(0.08, 1.0),
              hflip=False)

    def state():
        dense = ViT(bundle.cfg, generator=torch.Generator().manual_seed(1))
        tx = build_finetune_optimizer(dense, lr_schedule=lambda c: 1e-3,
                                      num_layers=bundle.cfg.depth)
        leaves = dict(dense.named_parameters())
        return tx, TrainState(0, dense, None, None, tx.init(leaves),
                              {n: p.detach().clone()
                               for n, p in leaves.items()})
    tx, fs = state()
    _, ps = state()
    mix = MixupConfig(mixup=0.8, cutmix=1.0)
    common = dict(num_classes=10, mixup_cfg=mix, ema_decay=0.9,
                  compute_dtype=torch.float32, device="cpu")
    fused = make_train_step(bundle.cfg, tx, fused_augment=True, **kw,
                            **common)
    plain = make_train_step(bundle.cfg, tx, **common)
    for k in range(2):
        x, y, draws, ready = batch(20 + k, **kw)
        assert not any(d.flip.any() for d in draws)
        fs, mf = fused(fs, x, y, torch.Generator().manual_seed(k),
                       augment_draws=draws)
        ps, mp = plain(ps, ready, y, torch.Generator().manual_seed(k))
        assert_same(fs, ps, mf, mp)
        for n in fs.ema_params:
            assert torch.equal(fs.ema_params[n], ps.ema_params[n]), n


def test_fused_steps_draw_from_the_generator_or_raise():
    bundle, scfg, tx, st = supernet_state()
    step = make_search_step(bundle.space, bundle.cfg, scfg, tx,
                            compute_dtype=torch.float32, device="cpu",
                            fused_augment=True)
    x, y, _, _ = batch(30)
    with pytest.raises(ValueError, match="generator"):
        step(st, x, y, None, 0.75)
    # with a generator the draws come from it: same seed, same step
    _, _, _, st2 = supernet_state()
    st, m1 = step(st, x, y, torch.Generator().manual_seed(3), 0.75)
    st2, m2 = step(st2, x, y, torch.Generator().manual_seed(3), 0.75)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    dense = ViT(bundle.cfg)
    ftx = build_finetune_optimizer(dense, lr_schedule=lambda c: 1e-3)
    train = make_train_step(bundle.cfg, ftx, num_classes=10,
                            fused_augment=True, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        train(TrainState(0, dense, None, None,
                         ftx.init(dict(dense.named_parameters()))), x, y)
