"""The JAX package's checkpoints read by the port (ofb_tpu_torch/core/msgpack.py
and core/checkpoint.py:load_checkpoint_raw, load_checkpoint), on the CPU.

* The decoder against `flax.serialization.msgpack_restore`, and the port's
  `load_checkpoint_raw` against the JAX package's, on every committed
  `runs/**/best/*.msgpack` (22 files in 11 run directories): the same
  trees, the arrays bit-equal; a bfloat16 / int / bool tree written by
  `flax.serialization.to_bytes`; the raise paths (a listed part missing,
  orbax, format_version 2, ext codes 2 and 3).
* A tiny JAX search saved by the JAX package after 2 steps: the port's
  `load_checkpoint` gives params, alphas, arch state, Adam moments and
  EMA equal to JAX's own restore, exactly; one more search step on each
  side agrees (the tolerances of test_torch_port_step.py). A finetune
  optimizer's state (layer-decay AdamW, with and without the plateau
  scale) loads exactly too.
* The CLIs on JAX directories: `cli.eval` of a JAX exported subnet and of a
  JAX supernet gives JAX's loss (rel 1e-4) and accuracy (within one image),
  `cli.finetune --finetune <JAX supernet>` exports what
  `scripts/finetune.py:load_searched_model` exports (the same config, the
  tensors to rtol 1e-6) and trains an epoch, `cli.export` writes it, and
  `cli.search --resume` continues a JAX run at its next epoch.
* The TPU searches committed in `runs/` export, from seeded weights and
  their alphas and arch state, to the subnets their TPU finetunes recorded.
"""

import dataclasses
import glob
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ofb_tpu.core import checkpoint as JCk
from ofb_tpu.core import compress as JC
from ofb_tpu.core import export as JEx
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu_torch.cli import eval as eval_cli
from ofb_tpu_torch.cli import export, finetune, search
from ofb_tpu_torch.cli.common import run_main, tiny_bundle
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.core import msgpack as M
from ofb_tpu_torch.core import optim as O
from ofb_tpu_torch.core.compress import compress
from ofb_tpu_torch.core.export import export_subnet
from ofb_tpu_torch.core.steps import TrainState, make_search_step
from ofb_tpu_torch.models.from_jax import (arch_to_numpy, flatten_from_jax,
                                           moments_from_jax)
from ofb_tpu_torch.models.registry import create_model
from test_torch_port_from_jax import jax_supernet, jax_token_mask, np_tree
from test_torch_port_step import build_tx, search_cfgs

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the committed TPU results: one real directory per run (some run
# directories are links to others)
RUN_DIRS = sorted({os.path.relpath(os.path.realpath(os.path.dirname(p)),
                                   REPO)
                   for p in glob.glob(os.path.join(REPO, "runs", "**",
                                                   "*.msgpack"),
                                      recursive=True)})
# the --tiny-test geometry of the CLIs, 1000 classes (SYNTHETIC's)
TINY = dict(img_size=32, patch_size=8, num_classes=1000, embed_dim=32,
            depth=2, num_heads=2, mlp_ratio=2.0, drop_path_rate=0.0)
ARGS = {"model": "deit_small_patch16_224_mim", "tiny_test": True,
        "tiny_dims": [32, 2, 2], "data_set": "SYNTHETIC"}
A, MB, KEEP = 2, 4, 0.75


def same_tree(got, want, path=""):
    """Dicts with the same keys in the same order, lists, scalars of one
    type and value, arrays of one dtype and shape with the same bytes (a
    bfloat16 array as the port's torch.bfloat16 tensor)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        if want.dtype.name == "bfloat16":
            assert isinstance(got, torch.Tensor), path
            assert got.dtype == torch.bfloat16, path
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def test_the_fixtures_are_the_committed_runs():
    assert len(RUN_DIRS) == 11
    files = [f for d in RUN_DIRS for f in glob.glob(os.path.join(
        REPO, d, "*.msgpack"))]
    assert len(files) == 22


@pytest.mark.parametrize("run", RUN_DIRS)
def test_decoder_and_raw_load_match_flax_on_committed_runs(run):
    path = os.path.join(REPO, run)
    for name in ("alphas", "arch"):
        with open(os.path.join(path, name + ".msgpack"), "rb") as f:
            data = f.read()
        same_tree(M.unpackb(data), serialization.msgpack_restore(data))
    got, want = ck.load_checkpoint_raw(path), JCk.load_checkpoint_raw(path)
    # the committed runs list params (and ema) but do not hold them
    assert set(got) == set(want) == {"meta", "alphas", "arch"}
    assert got["meta"] == want["meta"]
    for name in ("alphas", "arch"):
        same_tree(got[name], want[name], name)


def test_bfloat16_int_and_bool_leaves():
    tree = {"w": jnp.arange(-6, 6, dtype=jnp.bfloat16).reshape(3, 4) / 3,
            "i": {"a": np.arange(5, dtype=np.int32) - 2,
                  "b": np.array([2 ** 40, -7], np.int64),
                  "c": np.array(200, np.uint8)},
            "m": np.array([[True, False], [False, True]]),
            "h": np.linspace(-1, 1, 7).astype(np.float16),
            "d": np.array(np.pi), "e": np.zeros((0, 3), np.float32),
            "blocks": [{"x": np.ones(2, np.float32)},
                       {"x": np.zeros(2, np.float32)}], "none": {}}
    data = serialization.to_bytes(tree)
    got = M.unpackb(data)
    same_tree(got, serialization.msgpack_restore(data))
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.from_numpy(
        np.asarray(tree["w"], np.float32)))
    # plain msgpack values of every width flax writes
    plain = {"s": "text", "b": b"\x00\xff", "n": None, "t": True, "f": False,
             "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                      2 ** 63, -1, -32, -33, -128, -129, -2 ** 15 - 1,
                      -2 ** 31 - 1, -2 ** 63], "x": 1.5, "long": "y" * 300,
             "many": list(range(20)), "wide": {str(i): i for i in range(20)}}
    data = serialization.msgpack_serialize(plain)
    same_tree(M.unpackb(data), serialization.msgpack_restore(data))
    same_tree(M.destatedict(M.unpackb(data))["wide"], list(range(20)))


def _jax_dir(root, **meta):
    params = {"head": {"kernel": np.ones((2, 3), np.float32),
                       "bias": np.zeros((3,), np.float32)}}
    JCk.save_checkpoint(str(root), params=params, ema_params=params,
                        meta=meta)
    return str(root)


@pytest.mark.parametrize("case", ["missing_part", "orbax", "format_2",
                                  "ext_3", "ext_2", "truncated"])
def test_what_the_reader_refuses(tmp_path, case):
    path = _jax_dir(tmp_path / "j", epoch=1)
    meta_file = os.path.join(path, "meta.json")
    meta = json.load(open(meta_file))
    if case == "missing_part":
        os.remove(os.path.join(path, "ema.msgpack"))
        # the JAX package's loader skips the part; the port's raises
        assert "ema" not in JCk.load_checkpoint_raw(path)
        head = torch.nn.ModuleDict({"head": torch.nn.Linear(2, 3)})
        ema = {n: torch.zeros_like(p) for n, p in head.state_dict().items()}
        with pytest.raises(FileNotFoundError, match="'ema' listed"):
            ck.load_checkpoint(path, params=head, ema_params=ema)
        assert set(ck.load_checkpoint(path, params=head)) == {
            "meta", "params"}
        assert torch.equal(head.head.weight, torch.ones(3, 2))
        return
    if case == "orbax":
        meta["backend"] = "orbax"
        json.dump(meta, open(meta_file, "w"))
        for call in (ck.load_checkpoint_raw, ck.load_checkpoint):
            with pytest.raises(NotImplementedError, match="orbax"):
                call(path)
        return
    if case == "format_2":
        meta["format_version"] = 2
        json.dump(meta, open(meta_file, "w"))
        with pytest.raises(ValueError, match="format 2"):
            JCk.load_checkpoint(path, params={})
        for call in (ck.load_checkpoint_raw, ck.load_checkpoint):
            with pytest.raises(ValueError, match="format 2"):
                call(path)
        return
    if case == "truncated":
        with open(os.path.join(path, "params.msgpack"), "rb") as f:
            data = f.read()
        with pytest.raises(M.MsgpackError, match="truncated"):
            M.unpackb(data[:-5])
        with pytest.raises(M.MsgpackError, match="after"):
            M.unpackb(data + b"\xc0")
        return
    leaf = np.float32(2.5) if case == "ext_3" else complex(1.0, 2.0)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(serialization.msgpack_serialize({"head": {"scale": leaf}}))
    code = case[-1]
    with pytest.raises(M.MsgpackError, match=f"ext code {code}"):
        ck.load_checkpoint_raw(path)


# ---------------------------------------------------------------------------
# a JAX search, saved and resumed in the port
# ---------------------------------------------------------------------------

def _images(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, A, MB, 32, 32, 3)).astype(np.float32),
            rng.integers(0, TINY["num_classes"], (n, A, MB)))


def _masks(key, jcfg):
    return np.stack([jax_token_mask(jax.random.split(r, 3)[1], jcfg, MB,
                                    KEEP)
                     for r in jax.random.split(key, A)])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two JAX search steps saved by the JAX package (`supernet`), then a
    third step from JAX's restore of that directory; the same supernet
    force-finished and exported (`exported`), raw and EMA weights."""
    root = str(tmp_path_factory.mktemp("jax_ckpt"))
    jscfg, pscfg = search_cfgs()
    jcfg, jspace, jp, ja, jarch = jax_supernet(TINY, seed=3)
    jtx, _ = build_tx(JO, jscfg)
    state = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                          alphas=ja, arch=jarch,
                          opt_state=jtx.init((jp, ja)), ema_params=jp)
    step = JS.make_search_step(jspace, jcfg, jscfg, jtx, phase="search",
                               compute_dtype=jnp.float32, donate=False)
    images, labels = _images(1, 3)
    for k in range(2):
        state, _ = step(state, images[k], labels[k], jax.random.PRNGKey(k),
                        jnp.float32(KEEP))
    sdir = os.path.join(root, "supernet")
    JCk.save_checkpoint(sdir, params=state.params, alphas=state.alphas,
                        arch=state.arch, opt_state=state.opt_state,
                        ema_params=state.ema_params,
                        meta={"epoch": 1, "args": ARGS})
    # JAX's own restore into fresh templates, then one more step
    _, _, tp, ta, tarch = jax_supernet(TINY, seed=4)
    restored = JCk.load_checkpoint(sdir, params=tp, alphas=ta, arch=tarch,
                                   opt_state=jtx.init((tp, ta)),
                                   ema_params=tp)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32),
                           params=restored["params"],
                           alphas=restored["alphas"], arch=restored["arch"],
                           opt_state=restored["opt_state"],
                           ema_params=restored["ema"])
    key = jax.random.PRNGKey(7)
    jstate, jm = step(jstate, images[2], labels[2], key, jnp.float32(KEEP))

    # the supernet force-finished and exported by the JAX package
    params, alphas, arch = state.params, state.alphas, state.arch
    for _ in range(20):
        if arch.all_finished:
            break
        params, alphas, arch, _, _ = JC.compress(params, alphas, arch, None,
                                                 jspace, thresh=1.0)
    dense, dcfg, _ = JEx.export_subnet(params, arch, jspace, jcfg)
    ema = jax.tree_util.tree_map(lambda x: 0.5 * x, dense)
    xdir = os.path.join(root, "exported")
    JCk.save_checkpoint(xdir, params=dense, ema_params=ema, meta={
        "exported": True, "model_cfg": dataclasses.asdict(dcfg)})
    return dict(root=root, sdir=sdir, xdir=xdir, restored=restored,
                jstate=jstate, jmetrics={n: float(v) for n, v in jm.items()},
                images=images, labels=labels, mask=_masks(key, jcfg),
                pscfg=pscfg, dense=dense, dcfg=dcfg, ema=ema)


def _port_state(pscfg, seed=9):
    bundle = tiny_bundle(TINY["num_classes"], torch.device("cpu"))
    params, alphas, arch = bundle.init(seed)
    tx, _ = build_tx(O, pscfg)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(O.named_leaves(params, alphas)),
                       ema_params={n: p.detach().clone()
                                   for n, p in params.named_parameters()})
    return bundle, tx, state


def _load(path, state):
    return ck.load_checkpoint(path, params=state.params, alphas=state.alphas,
                              arch=state.arch, opt_state=state.opt_state,
                              ema_params=state.ema_params)


def test_resumed_state_equals_jax_restore(jax_run):
    bundle, _, state = _port_state(jax_run["pscfg"])
    objects = {n: id(p) for n, p in state.params.named_parameters()}
    out = _load(jax_run["sdir"], state)
    assert set(out) == {"meta", "params", "alphas", "arch", "opt_state",
                        "ema"} and out["meta"]["epoch"] == 1
    assert {n: id(p) for n, p in state.params.named_parameters()} == objects
    r = jax_run["restored"]
    for module, tree in ((state.params, r["params"]),
                         (state.alphas, r["alphas"])):
        want = flatten_from_jax(np_tree(tree))
        got = dict(module.named_parameters())
        assert set(got) == set(want)
        for n, a in want.items():
            np.testing.assert_array_equal(got[n].detach().numpy(), a, n)
    want = flatten_from_jax(np_tree(r["ema"]))
    assert set(state.ema_params) == set(want)
    for n, a in want.items():
        np.testing.assert_array_equal(state.ema_params[n].numpy(), a, n)
    got, want = arch_to_numpy(state.arch), arch_to_numpy(r["arch"])
    assert set(got) == set(want)
    for n, a in want.items():
        np.testing.assert_array_equal(got[n], a, n)
        assert got[n].dtype == a.dtype, n
    moments = moments_from_jax(r["opt_state"])
    assert int(state.opt_state.count) == moments["count"] == 2
    for which in ("mu", "nu"):
        live = getattr(state.opt_state, which)
        assert set(live) == set(moments[which])
        for n, a in moments[which].items():
            np.testing.assert_array_equal(live[n].numpy(), a, n)


def test_one_more_step_agrees_with_jax(jax_run):
    bundle, tx, state = _port_state(jax_run["pscfg"])
    _load(jax_run["sdir"], state)
    step = make_search_step(bundle.space, bundle.cfg, jax_run["pscfg"], tx,
                            compute_dtype=torch.float32, device="cpu")
    state, m = step(state, torch.from_numpy(jax_run["images"][2]),
                    torch.from_numpy(jax_run["labels"][2]), None, KEEP,
                    token_masks=torch.from_numpy(jax_run["mask"]))
    theirs = jax_run["jmetrics"]
    assert set(m) == set(theirs)
    for n, v in theirs.items():
        rel = 1e-4 if n == "grad_norm" else 1e-5
        assert m[n].item() == pytest.approx(v, rel=rel), n
    jst = jax_run["jstate"]
    want = flatten_from_jax(np_tree(jst.params))
    want.update({f"alphas.{n}": a for n, a in
                 flatten_from_jax(np_tree(jst.alphas)).items()})
    mine = O.named_leaves(state.params, state.alphas)
    assert set(mine) == set(want)
    for n, p in mine.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=2e-5, err_msg=n)
    assert int(state.opt_state.count) == 3


@pytest.mark.parametrize("plateau", [False, True])
def test_a_finetune_checkpoint_loads_moments_and_plateau_scale(tmp_path,
                                                               plateau):
    """A dense subnet's finetune state (layer-decay AdamW, optionally with
    the plateau scale) after one JAX update, saved by the JAX package: the
    port's finetune optimizer state takes its moments, count and scale
    exactly; a port state without the scale refuses one that has it."""
    from ofb_tpu.core import lr_decay as JL
    from ofb_tpu.models import vit as jvit
    from ofb_tpu_torch.core import lr_decay as LD
    from ofb_tpu_torch.models.vit import ModelCfg, ViT
    kw = dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=0.05,
              layer_decay=0.75, clip_grad=None)
    jcfg = jvit.ModelCfg(**TINY)
    jp = jvit.init_vit_params(jax.random.PRNGKey(2), jcfg)
    jtx = JL.build_finetune_optimizer(jp, lr_schedule=lambda c: 1e-3,
                                      num_layers=jcfg.depth, **kw)
    if plateau:
        jtx = JO.with_lr_scale(jtx)
    jst = jtx.init(jp)
    if plateau:
        jst = JO.set_lr_scale(jst, 0.25)
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(0, 0.1, a.shape), jnp.float32), jp)
    _, jst = jtx.update(grads, jst, jp)
    path = str(tmp_path / "ft")
    JCk.save_checkpoint(path, params=jp, opt_state=jst,
                        meta={"epoch": 0, "exported": True})

    def port_state(with_scale):
        params = ViT(ModelCfg(**TINY))
        tx = LD.build_finetune_optimizer(params, lr_schedule=lambda c: 1e-3,
                                         num_layers=jcfg.depth, **kw)
        if with_scale:
            tx = O.with_lr_scale(tx)
        return params, tx.init(dict(params.named_parameters()))

    params, st = port_state(plateau)
    ck.load_checkpoint(path, params=params, opt_state=st)
    adam = st.inner if plateau else st
    want = moments_from_jax(np_tree(jst))
    assert int(adam.count) == want["count"] == 1
    for which in ("mu", "nu"):
        got = getattr(adam, which)
        assert set(got) == set(want[which])
        for n, a in want[which].items():
            np.testing.assert_array_equal(got[n].numpy(), a, n)
    if plateau:
        assert st.scale.item() == 0.25
        with pytest.raises(KeyError, match="plateau scale"):
            ck.load_checkpoint(path, opt_state=port_state(False)[1])


# ---------------------------------------------------------------------------
# the CLIs on JAX directories
# ---------------------------------------------------------------------------

def _jax_eval(path, use_ema=False):
    """scripts/eval.py's evaluation, in process: SYNTHETIC val, fp32. A
    supernet directory of the tiny geometry is rebuilt as the port's CLIs
    rebuild it (scripts/eval.py itself takes a registry name)."""
    from ofb_tpu.config import DataConfig
    from ofb_tpu.core.engine import evaluate
    from ofb_tpu.data.datasets import build_dataset
    from ofb_tpu.data.pipeline import device_feed, make_epoch_loader
    from ofb_tpu.models.vit import ModelCfg, init_vit_params
    meta = JCk.latest_meta(path)
    if meta.get("exported"):
        cfg = JCk.model_cfg_from_meta(meta["model_cfg"], ModelCfg)
        tpl = init_vit_params(jax.random.PRNGKey(0), cfg)
        r = JCk.load_checkpoint(path, params=tpl, ema_params=tpl)
        step = JS.make_eval_step_dense(cfg, compute_dtype=jnp.float32)
        state_args = (r["ema" if use_ema else "params"],)
    else:
        cfg, space, p, a, arch = jax_supernet(TINY, seed=0)
        r = JCk.load_checkpoint(path, params=p, alphas=a, arch=arch)
        step = JS.make_eval_step(space, cfg, compute_dtype=jnp.float32)
        state_args = (r["params"], r["alphas"], r["arch"])
    dcfg = DataConfig(data_set="SYNTHETIC", input_size=cfg.img_size,
                      batch_size=512)
    ds, _ = build_dataset(False, dcfg, staging=256)
    loader = make_epoch_loader(ds, epoch=0, rank=0, world=1, batch_size=512,
                               repeated_aug=False, train=False)
    feed = device_feed(loader, rng=jax.random.PRNGKey(0), train=False,
                       accum_iter=1, out_size=cfg.img_size)
    return evaluate(step, feed, *state_args)


@pytest.mark.parametrize("which", ["exported", "exported_ema", "supernet"])
def test_eval_cli_on_jax_directories(jax_run, which):
    path = jax_run["sdir"] if which == "supernet" else jax_run["xdir"]
    ema = which.endswith("_ema")
    mine, _ = run_main(eval_cli, [
        "--checkpoint", path, "--data-set", "SYNTHETIC", "--device", "cpu",
        "--compute-dtype", "float32", "--batch-size", "512"]
        + (["--use-ema"] if ema else []))
    theirs = _jax_eval(path, ema)
    assert mine["loss"] == pytest.approx(float(theirs["loss"]), rel=1e-4)
    for k in ("acc1", "acc5"):
        assert abs(mine[k] - float(theirs[k])) <= 100.0 / 2048 + 1e-9, k


def _jax_load_searched_model(path):
    spec = importlib.util.spec_from_file_location(
        "jax_finetune_script", os.path.join(REPO, "scripts", "finetune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = mod.get_args_parser().parse_args(["--tiny-test"])
    return mod.load_searched_model(path, args, TINY["num_classes"])


def test_finetune_and_export_clis_take_a_jax_supernet(jax_run, tmp_path):
    jdense, jcfg = _jax_load_searched_model(jax_run["sdir"])
    args = finetune.get_args_parser().parse_args(["--tiny-test"])
    dense, cfg = finetune.load_searched_model(
        jax_run["sdir"], args, TINY["num_classes"], "cpu")
    jfields = dataclasses.asdict(jcfg)
    assert jfields["remat"] is False
    assert dataclasses.asdict(cfg) == jfields
    want = flatten_from_jax(np_tree(jdense))
    got = dict(dense.named_parameters())
    assert set(got) == set(want)
    for n, a in want.items():
        np.testing.assert_allclose(got[n].detach().numpy(), a, rtol=1e-6,
                                   atol=0, err_msg=n)
    # the export CLI writes the same subnet
    xdir = str(tmp_path / "exported")
    (xdense, xcfg), _ = run_main(export, [
        "--checkpoint", jax_run["sdir"], "--out", xdir, "--device", "cpu"])
    assert xcfg == cfg and ck.latest_meta(xdir)["exported"] is True
    # and the finetune CLI trains it for an epoch
    _, text = run_main(finetune, [
        "--data-set", "SYNTHETIC", "--tiny-test", "--finetune",
        jax_run["sdir"], "--epochs", "1", "--batch-size", "256", "--device",
        "cpu", "--compute-dtype", "float32", "--num_workers", "0",
        "--output_dir", str(tmp_path / "ft")])
    assert f"D={cfg.embed_dim}" in text and "Test[ema]:" in text
    best = ck.latest_meta(str(tmp_path / "ft" / "best"))
    assert best["model_cfg"]["block_overrides"] == [
        list(b) for b in cfg.block_overrides]


def test_search_cli_resumes_a_jax_run(jax_run, tmp_path):
    _, text = run_main(search, [
        "--data-set", "SYNTHETIC", "--tiny-test", "--compute-dtype",
        "float32", "--synthetic-size", "256", "--batch-size", "128",
        "--num_workers", "0", "--device", "cpu", "--epochs", "3",
        "--output_dir", str(tmp_path / "s"), "--resume", "--checkpoint",
        jax_run["sdir"]])
    assert f"resumed from {jax_run['sdir']} at epoch 2" in text
    assert "Epoch [2]" in text and "Epoch [1]" not in text
    meta = ck.latest_meta(str(tmp_path / "s" / "running_ckpt"))
    assert meta["epoch"] == 2


# ---------------------------------------------------------------------------
# the TPU searches committed in runs/
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", ["runs/organic_a8", "runs/ladder_organic/t0.45"])
def test_committed_searches_export_to_their_finetunes(run):
    meta = ck.latest_meta(os.path.join(REPO, run, "best"))
    assert meta["args"]["model"] == "deit_small_patch16_224_mim"
    bundle = create_model(meta["args"]["model"], device="cpu")
    params, alphas, arch = bundle.init(0)
    # the params are listed but not committed: asking for them raises
    with pytest.raises(FileNotFoundError, match="'params' listed"):
        ck.load_checkpoint(os.path.join(REPO, run, "best"), params=params,
                           alphas=alphas, arch=arch)
    out = ck.load_checkpoint(os.path.join(REPO, run, "best"),
                             alphas=alphas, arch=arch)
    assert set(out) == {"meta", "alphas", "arch"}
    for _ in range(20):
        if arch.all_finished:
            break
        params, alphas, arch, _, _ = compress(params, alphas, arch, None,
                                              bundle.space, thresh=1.0)
    _, dcfg, _ = export_subnet(params, arch, bundle.space, bundle.cfg,
                               fuse=True)
    ft = ck.latest_meta(os.path.join(REPO, run, "ft", "best"))["model_cfg"]
    assert dcfg.embed_dim == ft["embed_dim"] == 276
    assert [list(b) for b in dcfg.block_overrides] == ft["block_overrides"]
    # the finetune's config as the port reads it (remat kept)
    cfg = ck.model_cfg_from_meta(ft, type(dcfg))
    assert cfg.block_overrides == dcfg.block_overrides
    assert cfg.remat is ft["remat"]
