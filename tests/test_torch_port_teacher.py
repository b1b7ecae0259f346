"""The port's KD teacher (ofb_tpu_torch/models/regnet.py, teacher.py and
the teacher in the search and train steps) against ofb_tpu on the CPU, in
fp32, from the same weights:

* the RegNetY forward against `regnet_forward` on a tiny config with folded
  BN affines that are not the identity: logits within 1e-5 of their largest
  magnitude (convolutions sum in another order);
* `torch_regnet_to_params` on a seeded timm-layout state dict: the port's
  loader gives the tensors `from_jax` makes of JAX's import (exactly: both
  fold the BN in float64), and the same logits;
* K = 3 search steps and K = 3 train steps with a RegNetY teacher, soft and
  hard distillation, against JAX's steps: metrics rel 1e-5 (grad_norm
  1e-4), params atol 2e-5, as in test_torch_port_step.py;
* `build_teacher`'s three branches: RegNetY from a seed or a state dict, a
  registry DeiT through `torch_import`, a port checkpoint directory (its
  EMA weights, or a finetune's eval winner), and a JAX package checkpoint
  directory (a finetune's best: its eval winner, JAX's logits within 1e-5
  of their largest magnitude);
* a dense Swin name (`swin_tiny_patch4_window7_224`): the port's seeded
  teacher, its weights replaced by those of JAX's `build_teacher` (seed 7,
  carried over with `from_jax`), gives JAX's fp32 logits within 1e-5 of
  their largest magnitude; a Swin checkpoint directory exits with the JAX
  package's message.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.config import DistillationConfig as JDist
from ofb_tpu.core import lr_decay as JL
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu.models import regnet as JR
from ofb_tpu.models import vit as jvit
from ofb_tpu_torch.config import DistillationConfig
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.core import lr_decay as LD
from ofb_tpu_torch.core import optim as O
from ofb_tpu_torch.core import steps as S
from ofb_tpu_torch.models import regnet as R
from ofb_tpu_torch.models.from_jax import (flatten_from_jax, load_from_jax,
                                           regnet_from_jax)
from ofb_tpu_torch.models.teacher import build_teacher
from ofb_tpu_torch.models.vit import ModelCfg, ViT
from test_torch_port_from_jax import (TINY, jax_supernet, jax_token_mask,
                                      np_tree, port_supernet)
from test_torch_port_step import A, KEEP, MB, build_tx, search_cfgs

torch.set_num_threads(1)
K = 3
RCFG = dict(depths=(1, 1, 1, 1), widths=(8, 16, 32, 64), group_width=8,
            num_classes=TINY["num_classes"])


def jax_regnet(seed=0):
    """A tiny JAX RegNet tree whose folded BN affines are not the
    identity."""
    cfg = JR.RegNetCfg(**RCFG)
    tree = np_tree(JR.init_regnet_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias"}:
                n = node["scale"].shape
                return {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32)}
            return {k: perturb(v) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v) for v in node]
        return node

    return cfg, perturb(tree)


def timm_state_dict(cfg, seed=1):
    """A seeded state dict in timm's RegNetY layout (numpy)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[name + ".weight"] = rng.normal(0, np.sqrt(2 / (k * k * cin)),
                                          (cout, cin, k, k)).astype(np.float32)

    def bn(name, c):
        sd[name + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[name + ".bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[name + ".running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[name + ".running_var"] = rng.uniform(0.5, 2, c).astype(np.float32)
        sd[name + ".num_batches_tracked"] = np.asarray(7)

    conv("stem.conv", cfg.stem_width, 3, 3)
    bn("stem.bn", cfg.stem_width)
    w_in = cfg.stem_width
    for s, (d, w) in enumerate(zip(cfg.depths, cfg.widths)):
        for b in range(d):
            p = f"s{s + 1}.b{b + 1}"
            se = max(1, int(round(cfg.se_ratio * w_in)))
            conv(p + ".conv1.conv", w, w_in, 1)
            bn(p + ".conv1.bn", w)
            conv(p + ".conv2.conv", w, w // (w // cfg.group_width), 3)
            bn(p + ".conv2.bn", w)
            conv(p + ".se.fc1", se, w, 1)
            sd[p + ".se.fc1.bias"] = rng.normal(0, 0.1, se).astype(np.float32)
            conv(p + ".se.fc2", w, se, 1)
            sd[p + ".se.fc2.bias"] = rng.normal(0, 0.1, w).astype(np.float32)
            conv(p + ".conv3.conv", w, w, 1)
            bn(p + ".conv3.bn", w)
            if b == 0:
                conv(p + ".downsample.conv", w, w_in, 1)
                bn(p + ".downsample.bn", w)
            w_in = w
    sd["head.fc.weight"] = rng.normal(0, 0.05, (cfg.num_classes, w_in)) \
        .astype(np.float32)
    sd["head.fc.bias"] = rng.normal(0, 0.1, cfg.num_classes).astype(np.float32)
    return sd


def close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def test_regnet_forward_matches_jax():
    jcfg, tree = jax_regnet()
    x = np.random.default_rng(2).normal(0, 1, (2, 32, 32, 3)) \
        .astype(np.float32)
    want = JR.regnet_forward(tree, jnp.asarray(x), jcfg,
                             compute_dtype=jnp.float32)
    model = regnet_from_jax(tree, R.RegNetCfg(**RCFG),
                            compute_dtype=torch.float32)
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and not got.requires_grad
    assert all(not p.requires_grad for p in model.parameters())
    close(got.numpy(), want)
    assert np.abs(np.asarray(want)).max() > 1e-3      # not a vanishing net


def test_timm_regnet_import_matches_jax():
    cfg = R.RegNetCfg(**RCFG)
    sd = timm_state_dict(cfg)
    jtree = np_tree(JR.torch_regnet_to_params(sd, JR.RegNetCfg(**RCFG)))
    model = R.torch_regnet_to_params(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, cfg,
        R.init_regnet(cfg, compute_dtype=torch.float32))
    want = flatten_from_jax(jtree)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for n, p in got.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)
    x = np.random.default_rng(3).normal(0, 1, (2, 32, 32, 3)) \
        .astype(np.float32)
    close(model(torch.from_numpy(x)).numpy(),
          JR.regnet_forward(jtree, jnp.asarray(x), JR.RegNetCfg(**RCFG),
                            compute_dtype=jnp.float32))
    # a state dict that lacks a key raises
    sd.pop("s2.b1.conv2.bn.running_var")
    with pytest.raises(KeyError):
        R.torch_regnet_to_params(sd, cfg, R.init_regnet(cfg))


def teachers(seed=0):
    jcfg, tree = jax_regnet(seed)
    jt = lambda imgs: JR.regnet_forward(tree, imgs, jcfg,   # noqa: E731
                                        compute_dtype=jnp.float32)
    pt = regnet_from_jax(tree, R.RegNetCfg(**RCFG),
                         compute_dtype=torch.float32)
    return jt, pt


@pytest.mark.parametrize("kind", ["soft", "hard"])
def test_search_steps_with_a_teacher_match_jax(kind):
    jscfg, pscfg = search_cfgs()
    jscfg = dataclasses.replace(jscfg, distillation=JDist(
        distillation_type=kind, alpha=0.5, tau=2.0))
    pscfg = dataclasses.replace(pscfg, distillation=DistillationConfig(
        distillation_type=kind, alpha=0.5, tau=2.0))
    jcfg, jspace, jp, ja, jarch = jax_supernet(TINY, seed=6)
    cfg, space, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    jt, pt = teachers(1)
    rng = np.random.default_rng(12)
    images = rng.uniform(0, 1, (K, A, MB, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, TINY["num_classes"], (K, A, MB))

    jtx = build_tx(JO, jscfg)[0]
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=ja, arch=jarch, opt_state=jtx.init((jp, ja)))
    jstep = JS.make_search_step(jspace, jcfg, jscfg, jtx, phase="search",
                                teacher_apply=jt, compute_dtype=jnp.float32,
                                donate=False)
    tx = build_tx(O, pscfg)[0]
    state = S.TrainState(step=0, params=params, alphas=alphas, arch=arch,
                         opt_state=tx.init(O.named_leaves(params, alphas)))
    step = S.make_search_step(space, cfg, pscfg, tx, teacher_apply=pt,
                              compute_dtype=torch.float32, device="cpu")
    plain = S.make_search_step(space, cfg, pscfg, tx,
                               compute_dtype=torch.float32, device="cpu")
    for k in range(K):
        key = jax.random.PRNGKey(300 + k)
        masks = np.stack([jax_token_mask(jax.random.split(r, 3)[1], jcfg,
                                         MB, KEEP)
                          for r in jax.random.split(key, A)])
        jstate, jm = jstep(jstate, images[k], labels[k], key,
                           jnp.float32(KEEP))
        if k == 0:
            # the teacher moves the loss: the same step without it differs
            import copy
            side = copy.deepcopy(state)
            _, m0 = plain(side, torch.from_numpy(images[k]),
                          torch.from_numpy(labels[k]), None, KEEP,
                          token_masks=torch.from_numpy(masks))
        state, m = step(state, torch.from_numpy(images[k]),
                        torch.from_numpy(labels[k]), None, KEEP,
                        token_masks=torch.from_numpy(masks))
        if k == 0:
            assert abs(m0["loss_param"].item() - m["loss_param"].item()) \
                > 1e-4
        for n, v in jm.items():
            assert m[n].item() == pytest.approx(
                float(v), rel=1e-4 if n == "grad_norm" else 1e-5), (k, n)
    want = flatten_from_jax(np_tree(jstate.params))
    want.update({f"alphas.{n}": a for n, a in
                 flatten_from_jax(np_tree(jstate.alphas)).items()})
    for n, p in O.named_leaves(state.params, state.alphas).items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=2e-5, err_msg=n)
    assert all(p.grad is None for p in pt.parameters())


@pytest.mark.parametrize("kind", ["soft", "hard"])
def test_train_steps_with_a_teacher_match_jax(kind):
    jcfg = jvit.ModelCfg(**TINY)
    jp = jvit.init_vit_params(jax.random.PRNGKey(4), jcfg)
    cfg = ModelCfg(**TINY)
    params = load_from_jax(ViT(cfg), np_tree(jp))
    jt, pt = teachers(2)
    rng = np.random.default_rng(13)
    images = rng.uniform(0, 1, (K, A, MB, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, TINY["num_classes"], (K, A, MB))
    sched = lambda c: 1e-3 * (0.5 ** c)                     # noqa: E731
    opt = dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=0.05,
               layer_decay=0.75, clip_grad=0.5, num_layers=cfg.depth)

    jtx = JL.build_finetune_optimizer(
        jp, lr_schedule=lambda c: 1e-3 * (0.5 ** jnp.asarray(c, jnp.float32)),
        **opt)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=None, arch=None, opt_state=jtx.init(jp))
    jstep = JS.make_train_step(
        jcfg, jtx, num_classes=TINY["num_classes"], smoothing=0.1,
        teacher_apply=jt, distill=JDist(distillation_type=kind, alpha=0.5,
                                        tau=2.0),
        compute_dtype=jnp.float32, donate=False)
    tx = LD.build_finetune_optimizer(params, lr_schedule=sched, **opt)
    state = S.TrainState(step=0, params=params, alphas=None, arch=None,
                         opt_state=tx.init(dict(params.named_parameters())))
    step = S.make_train_step(
        cfg, tx, num_classes=TINY["num_classes"], smoothing=0.1,
        teacher_apply=pt, distill=DistillationConfig(
            distillation_type=kind, alpha=0.5, tau=2.0),
        compute_dtype=torch.float32, device="cpu")
    for k in range(K):
        jstate, jm = jstep(jstate, images[k], labels[k],
                           jax.random.PRNGKey(k))
        state, m = step(state, torch.from_numpy(images[k]),
                        torch.from_numpy(labels[k]))
        assert m["loss"].item() == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5), k
    want = flatten_from_jax(np_tree(jstate.params))
    for n, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=2e-5, err_msg=n)


def test_build_teacher_branches(tmp_path):
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    # RegNetY from the seed, then from a timm state dict
    cfg = R.RegNetCfg(**RCFG)
    name = "regnety_tiny_test"
    R.REGNET_CFGS[name] = cfg
    try:
        seeded = build_teacher(name, num_classes=16,
                               compute_dtype=torch.float32, device="cpu")
        again = build_teacher(name, num_classes=16,
                              compute_dtype=torch.float32, device="cpu")
        assert torch.equal(seeded(x), again(x))
        sd = {k: torch.from_numpy(np.asarray(v))
              for k, v in timm_state_dict(cfg).items()}
        torch.save({"model": sd}, tmp_path / "regnet.pth")
        loaded = build_teacher(name, teacher_path=str(tmp_path / "regnet.pth"),
                               num_classes=16, compute_dtype=torch.float32,
                               device="cpu")
        want = R.torch_regnet_to_params(sd, cfg, R.init_regnet(
            cfg, compute_dtype=torch.float32))(x)
        assert torch.equal(loaded(x), want)
    finally:
        del R.REGNET_CFGS[name]
    # a registry DeiT through torch_import
    from ofb_tpu_torch.models.registry import create_model
    from ofb_tpu_torch.models.torch_import import params_to_torch_state_dict
    deit = create_model("deit_tiny_patch16_224", num_classes=10,
                        device="cpu").init(3)
    torch.save({k: torch.from_numpy(v) for k, v in
                params_to_torch_state_dict(deit).items()},
               tmp_path / "deit.pth")
    t = build_teacher("deit_tiny_patch16_224",
                      teacher_path=str(tmp_path / "deit.pth"), num_classes=10,
                      compute_dtype=torch.float32, device="cpu")
    x224 = torch.rand(1, 224, 224, 3, generator=torch.Generator()
                      .manual_seed(1))
    from ofb_tpu_torch.models.vit import vit_forward
    torch.testing.assert_close(t(x224), vit_forward(
        deit, x224, deit_cfg(), compute_dtype=torch.float32))
    # a port checkpoint directory: its EMA weights when it has them
    vcfg = ModelCfg(**TINY)
    params, ema = ViT(vcfg), ViT(vcfg, generator=torch.Generator()
                                 .manual_seed(9))
    d = str(tmp_path / "ft")
    ck.save_checkpoint(d, params=params, ema_params=dict(
        ema.named_parameters()), meta={"exported": True, "model_cfg":
                                       dataclasses.asdict(vcfg)})
    t = build_teacher("ignored", teacher_path=d, num_classes=16,
                      compute_dtype=torch.float32, device="cpu")
    from ofb_tpu_torch.models.vit import vit_forward as vf
    torch.testing.assert_close(t(x), vf(ema, x, vcfg,
                                        compute_dtype=torch.float32))
    # a finetune's best: the eval winner is in params, the teacher takes it
    ck.save_checkpoint(d, params=params, ema_params=dict(
        ema.named_parameters()), meta={"exported": True, "eval_winner": "raw",
                                       "model_cfg": dataclasses.asdict(vcfg)})
    t = build_teacher("ignored", teacher_path=d, num_classes=16,
                      compute_dtype=torch.float32, device="cpu")
    torch.testing.assert_close(t(x), vf(params, x, vcfg,
                                        compute_dtype=torch.float32))
    # a JAX package checkpoint directory: a finetune's best, its eval
    # winner in params, JAX's forward of those weights
    from ofb_tpu.core import checkpoint as JCk
    jcfg = jvit.ModelCfg(**TINY)
    jraw = jvit.init_vit_params(jax.random.PRNGKey(5), jcfg)
    jema = jax.tree_util.tree_map(lambda a: 0.5 * a, jraw)
    j = str(tmp_path / "jax_ck")
    JCk.save_checkpoint(j, params=jraw, ema_params=jema, meta={
        "exported": True, "eval_winner": "raw",
        "model_cfg": dataclasses.asdict(jcfg)})
    assert json.load(open(tmp_path / "jax_ck" / "meta.json"))["parts"] == [
        "params", "ema"]
    t = build_teacher("x", teacher_path=j, num_classes=16,
                      compute_dtype=torch.float32, device="cpu")
    want = jvit.vit_forward(jraw, jnp.asarray(x.numpy()), jcfg,
                            compute_dtype=jnp.float32)
    np.testing.assert_allclose(t(x).numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    with pytest.raises(SystemExit):
        build_teacher("no_such_model", num_classes=16, device="cpu")


def deit_cfg():
    from ofb_tpu_torch.models.registry import create_model
    return create_model("deit_tiny_patch16_224", num_classes=10,
                        device="cpu").cfg


SWIN_T = "swin_tiny_patch4_window7_224"


def test_dense_swin_teacher_matches_jax():
    from ofb_tpu.models import registry as JReg
    from ofb_tpu.models.teacher import build_teacher as jax_build_teacher
    from ofb_tpu.parallel.mesh import make_mesh
    x = np.random.RandomState(0).rand(1, 224, 224, 3).astype(np.float32)
    jt = jax_build_teacher(SWIN_T, num_classes=10, mesh=make_mesh(),
                           compute_dtype=jnp.float32)
    want = np.asarray(jt(jnp.asarray(x)))
    assert want.shape == (1, 10)
    t = build_teacher(SWIN_T, num_classes=10, compute_dtype=torch.float32,
                      device="cpu")
    seeded = t(torch.from_numpy(x))
    assert seeded.shape == (1, 10) and torch.isfinite(seeded).all()
    assert not any(p.requires_grad for p in t.model.parameters())
    # JAX's teacher weights: the registry's init at the teacher seed
    jparams = JReg.create_model(SWIN_T, num_classes=10).init(
        jax.random.PRNGKey(7))
    load_from_jax(t.model, np_tree(jparams))
    got = t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_swin_checkpoint_teacher_is_refused(tmp_path):
    from ofb_tpu_torch.models import swin as SW
    cfg = SW.SwinCfg(img_size=32, patch_size=2, num_classes=10, embed_dim=24,
                     depths=(1, 1), num_heads=(2, 4), window=4,
                     mlp_ratio=2.0)
    d = str(tmp_path / "swin_ft")
    ck.save_checkpoint(d, params=SW.Swin(cfg), meta={
        "family": "swin", "exported": True,
        "model_cfg": dataclasses.asdict(cfg)})
    with pytest.raises(SystemExit, match="swin teacher checkpoints are not "
                       "supported as KD teachers yet"):
        build_teacher("ignored", teacher_path=d, num_classes=10,
                      device="cpu")
