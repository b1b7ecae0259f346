"""The port's checkpoints (ofb_tpu_torch/core/checkpoint.py) on the CPU:
`<part>.pt` files plus `meta.json` written last, restored in place.

Round trips are bit-identical: every tensor of the supernet's params,
alphas, arch state, optimizer state and EMA, and of an exported subnet. A
directory the JAX package wrote is read in place, and a part its meta
lists but whose file is missing raises (test_torch_port_jax_checkpoint.py
holds the rest of the JAX reader).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from ofb_tpu.core import checkpoint as JCk
from ofb_tpu_torch.cli.common import tiny_bundle
from ofb_tpu_torch.config import SearchConfig
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.core.optim import (build_search_optimizer, named_leaves,
                                      set_lr_scale, with_lr_scale)
from ofb_tpu_torch.core.steps import TrainState, make_search_step
from ofb_tpu_torch.models.vit import ModelCfg, ViT

torch.set_num_threads(1)


def supernet(seed, plateau=False):
    bundle = tiny_bundle(10, "cpu")
    params, alphas, arch = bundle.init(seed)
    scfg = SearchConfig(accum_iter=1).resolve(1)
    tx, _ = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=100, steps_per_epoch=10)
    if plateau:
        tx = with_lr_scale(tx)
    state = TrainState(0, params, alphas, arch,
                       tx.init(named_leaves(params, alphas)),
                       {n: p.detach().clone()
                        for n, p in params.named_parameters()})
    return bundle, scfg, tx, state


def stepped(seed, plateau=False):
    """A supernet after one search step, with a touched arch state."""
    bundle, scfg, tx, state = supernet(seed, plateau)
    step = make_search_step(bundle.space, bundle.cfg, scfg, tx,
                            compute_dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((1, 4, 32, 32, 3), generator=g)
    y = torch.randint(0, 10, (1, 4), generator=g)
    state, _ = step(state, x, y, g, 0.75)
    with torch.no_grad():
        state.arch.blocks[1].attn.switch[0, 0] = False
        state.arch.embed.w_p.fill_(0.25)
        state.arch.patch.finished.fill_(True)
        for e in state.ema_params.values():
            e.mul_(0.5)
    if plateau:
        set_lr_scale(state.opt_state, 0.01)
    return state


def snapshot(state):
    adam = getattr(state.opt_state, "inner", state.opt_state)
    out = {f"p.{n}": t.clone() for n, t in state.params.state_dict().items()}
    out.update({f"a.{n}": t.clone()
                for n, t in state.alphas.state_dict().items()})
    out.update({f"s.{n}": t.clone()
                for n, t in ck._arch_tensors(state.arch).items()})
    out.update({f"mu.{n}": t.clone() for n, t in adam.mu.items()})
    out.update({f"nu.{n}": t.clone() for n, t in adam.nu.items()})
    out.update({f"e.{n}": t.clone() for n, t in state.ema_params.items()})
    if hasattr(state.opt_state, "scale"):
        out["scale"] = state.opt_state.scale.clone()
    return out, adam.count


def save(path, state, **kw):
    ck.save_checkpoint(str(path), params=state.params, alphas=state.alphas,
                       arch=state.arch, opt_state=state.opt_state,
                       ema_params=state.ema_params, **kw)


def load(path, state):
    return ck.load_checkpoint(str(path), params=state.params,
                              alphas=state.alphas, arch=state.arch,
                              opt_state=state.opt_state,
                              ema_params=state.ema_params)


@pytest.mark.parametrize("plateau", [False, True])
def test_supernet_round_trip_is_bit_identical(tmp_path, plateau):
    src = stepped(1, plateau)
    want, count = snapshot(src)
    save(tmp_path / "ck", src, meta={"epoch": 3, "args": {"model": "tiny"}})
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "alphas.pt", "arch.pt", "ema.pt", "meta.json", "opt_state.pt",
        "params.pt"]
    dst = supernet(2, plateau)[3]
    objects = [id(p) for p in dst.params.parameters()]
    out = load(tmp_path / "ck", dst)
    assert out["meta"]["epoch"] == 3 and out["meta"]["format_version"] == 1
    assert out["meta"]["parts"] == ["params", "alphas", "arch", "opt_state",
                                    "ema"]
    assert out["params"] is dst.params
    got, got_count = snapshot(dst)
    assert got_count == count == 1 and set(got) == set(want)
    for n, t in want.items():
        assert torch.equal(got[n], t) and got[n].dtype == t.dtype, n
    # restored in place: the same tensors as before
    assert objects == [id(p) for p in dst.params.parameters()]
    assert ck.latest_meta(str(tmp_path / "ck"))["args"] == {"model": "tiny"}


def test_exported_subnet_round_trip(tmp_path):
    cfg = ModelCfg(img_size=32, patch_size=8, num_classes=7, embed_dim=24,
                   depth=2, num_heads=2, mlp_ratio=2.0,
                   block_overrides=((2, 8, 40), (3, 16, 24)))
    src = ViT(cfg, generator=torch.Generator().manual_seed(0))
    ck.save_checkpoint(str(tmp_path / "x"), params=src, meta={
        "exported": True, "model_cfg": dataclasses.asdict(cfg)})
    meta = ck.latest_meta(str(tmp_path / "x"))
    cfg2 = ck.model_cfg_from_meta(meta["model_cfg"], ModelCfg)
    assert cfg2 == cfg
    dst = ViT(cfg2, generator=torch.Generator().manual_seed(1))
    ck.load_checkpoint(str(tmp_path / "x"), params=dst)
    for (n, a), (_, b) in zip(src.state_dict().items(),
                              dst.state_dict().items()):
        assert torch.equal(a, b), n
    # an EMA dict in the 'params' slot loads into a module of that shape
    ema = {n: p.detach() * 2 for n, p in src.named_parameters()}
    ck.save_checkpoint(str(tmp_path / "e"), params=ema, ema_params=src)
    back = ViT(cfg2)
    other = ViT(cfg2)
    out = ck.load_checkpoint(str(tmp_path / "e"), params=back,
                             ema_params=other)
    assert set(out) == {"meta", "params", "ema"}
    assert torch.equal(back.head.weight, 2 * src.head.weight.detach())
    assert torch.equal(other.head.weight, src.head.weight.detach())


def test_async_save_keeps_the_pre_step_values(tmp_path):
    state = stepped(3)
    want, _ = snapshot(state)
    save(tmp_path / "a", state, meta={"epoch": 0}, async_write=True)
    # the next steps update everything in place while the writer runs
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
        for m in state.opt_state.mu.values():
            m.add_(1.0)
        for e in state.ema_params.values():
            e.add_(1.0)
    ck.wait_for_pending_saves()
    dst = supernet(4)[3]
    load(tmp_path / "a", dst)
    got, _ = snapshot(dst)
    for n, t in want.items():
        assert torch.equal(got[n], t), n


def test_meta_is_written_last_and_required(tmp_path, monkeypatch):
    state = supernet(5)[3]
    order = []
    real = os.replace

    def record(src, dst):
        order.append(os.path.basename(dst))
        return real(src, dst)
    monkeypatch.setattr(os, "replace", record)
    save(tmp_path / "m", state)
    monkeypatch.setattr(os, "replace", real)
    assert order[-1] == "meta.json" and len(order) == 6
    # a directory whose meta was never written is not loaded
    os.remove(tmp_path / "m" / "meta.json")
    with pytest.raises(FileNotFoundError, match="meta.json"):
        load(tmp_path / "m", supernet(6)[3])
    # nor one whose meta lists a part that is missing
    save(tmp_path / "n", state)
    os.remove(tmp_path / "n" / "arch.pt")
    with pytest.raises(FileNotFoundError, match="arch"):
        load(tmp_path / "n", supernet(6)[3])
    # a part whose shapes differ from the live model raises
    save(tmp_path / "o", state)
    with pytest.raises((KeyError, RuntimeError, ValueError)):
        ck.load_checkpoint(str(tmp_path / "o"),
                           params=ViT(ModelCfg(embed_dim=8, depth=1,
                                               num_heads=1, img_size=16,
                                               patch_size=8)))


def _jax_checkpoint(path, **parts):
    params = {"head": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "bias": np.ones((3,), np.float32)}}
    JCk.save_checkpoint(str(path), params=jax.tree_util.tree_map(
        jax.numpy.asarray, params), meta={"epoch": 1}, **parts)
    assert json.load(open(path / "meta.json"))["parts"] == \
        ["params"] + ["ema"] * ("ema_params" in parts)
    return params


def _head_module():
    """A module holding only a (3, 2) linear `head`, the JAX tree's."""
    m = torch.nn.Module()
    m.head = ViT(ModelCfg(embed_dim=2, depth=0, num_heads=1, img_size=8,
                          patch_size=8, num_classes=3)).head
    return m


def test_a_jax_checkpoint_raises(tmp_path):
    """A JAX checkpoint whose meta lists a part that is missing raises
    when the part is asked for (the JAX package's loader skips it)."""
    params = _jax_checkpoint(tmp_path / "j", ema_params=jax.tree_util
                             .tree_map(jax.numpy.asarray, {"x": np.ones(1)}))
    os.remove(tmp_path / "j" / "ema.msgpack")
    with pytest.raises(FileNotFoundError, match="'ema' listed"):
        ck.load_checkpoint(str(tmp_path / "j"), params=_head_module(),
                           ema_params={})
    assert set(JCk.load_checkpoint(str(tmp_path / "j"), params=params)) == \
        {"meta", "params"}


def test_a_jax_checkpoint_is_read_in_place(tmp_path):
    params = _jax_checkpoint(tmp_path / "j")
    head = _head_module()
    weight = head.head.weight
    out = ck.load_checkpoint(str(tmp_path / "j"), params=head)
    assert out["params"] is head and head.head.weight is weight
    assert torch.equal(weight, torch.from_numpy(params["head"]["kernel"].T))
    assert torch.equal(head.head.bias, torch.ones(3))
    # a module whose names differ raises
    with pytest.raises(KeyError, match="differ"):
        ck.load_checkpoint(str(tmp_path / "j"),
                           params=supernet(0)[3].params)
