"""The port's performance tools (ofb_tpu_torch/scripts/{perf_breakdown,
augment_breakdown,swin_breakdown,data_bench,kpad_probe}.py) against the
JAX package's scripts of the same names, on the CPU at small sizes.

Weights come over through `models/from_jax.py`; the tiny supernet and the
Swin config have no stochastic depth, so no randomness crosses between
the frameworks (the search rows take a torch generator and are held to
their own invariants). A JAX script's printed keys and variant names are
read from its source (the scripts run only on a TPU or take minutes on
the CPU); data_bench, which imports no JAX, is run beside the port's.

Tolerances: eval metrics loss_sum rel 1e-5, counts exact; the dense
step's losses rel 1e-5 and parameters atol 2e-5 (the k third of a qkv
bias, whose gradient is analytically zero, within the two steps' Adam
moves of 2 x lr of the start); sgd updates rtol 1e-6; the augment
variants exactly (the full one against `apply_train_augment`) or atol
1e-4 in 0-255 units (eval resize, shift passes against JAX), the bf16
candidate's mean delta <= 0.017 (one uint8 step in normalised units, the
JAX script's yardstick); the Swin ablations' fp32 logits rtol 1e-5 with
atol 1e-5 of the largest magnitude; kpad's padded chain rtol 1e-5 (fp32).
"""

import ast
import json
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ofb_tpu.core import steps as JS
from ofb_tpu.data.datasets import _ResizeU8
from ofb_tpu.models import mim_vit as jmim
from ofb_tpu.models import swin as js
from ofb_tpu.models import vit as jvit
from ofb_tpu.ops import augment as JA
from ofb_tpu_torch.bench import search_config
from ofb_tpu_torch.core import optim as O
from ofb_tpu_torch.core.steps import TrainState
from ofb_tpu_torch.data.datasets import resize_u8
from ofb_tpu_torch.models import swin as S
from ofb_tpu_torch.models.from_jax import flatten_from_jax, load_from_jax
from ofb_tpu_torch.models.mim_vit import init_mim_params
from ofb_tpu_torch.models.registry import ModelBundle
from ofb_tpu_torch.models.vit import ViT
from ofb_tpu_torch.ops import augment as A
from ofb_tpu_torch.scripts import augment_breakdown as AB
from ofb_tpu_torch.scripts import data_bench as DB
from ofb_tpu_torch.scripts import kpad_probe as KP
from ofb_tpu_torch.scripts import perf_breakdown as PB
from ofb_tpu_torch.scripts import swin_breakdown as SB
from test_torch_port_from_jax import TINY, jax_supernet, np_tree, port_supernet
from test_torch_port_swin import CFG as SWIN_CFG
from test_torch_port_swin import close, images, scaled

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def jax_source(name):
    return ast.parse((REPO / "scripts" / name).read_text())


def dict_keys(tree, var=None):
    """String keys of the dict literals in a script (those assigned to
    `var`, or passed to json.dumps when var is None)."""
    keys = set()
    for node in ast.walk(tree):
        d = None
        if var and isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == var for t in node.targets):
            d = node.value
        elif var is None and isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "dumps" and node.args:
            d = node.args[0]
        if isinstance(d, ast.Dict):
            keys |= {k.value for k in d.keys if isinstance(k, ast.Constant)}
    return keys


# ---------------------------------------------------------------------------
# perf_breakdown
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    jcfg, jspace, jp, ja, jarch = jax_supernet(TINY)
    cfg, space, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    bundle = ModelBundle(name="tiny", cfg=cfg, space=space, device=CPU)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (1, 8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, TINY["num_classes"], (1, 8))
    return dict(jax=(jcfg, jspace, jp, ja, jarch), bundle=bundle,
                port=(params, alphas, arch), x=x, y=y)


def test_eval_row_matches_jax_eval_step(tiny_pair):
    jcfg, jspace, jp, ja, jarch = tiny_pair["jax"]
    params, alphas, arch = tiny_pair["port"]
    x, y = tiny_pair["x"], tiny_pair["y"]
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=None)
    call, box = PB.eval_call(tiny_pair["bundle"], state, torch.from_numpy(x),
                             torch.from_numpy(y), torch.float32)
    assert call() is box["m"]["loss_sum"]
    jm = JS.make_eval_step(jspace, jcfg, compute_dtype=jnp.float32)(
        jp, ja, jarch, x[0], y[0])
    assert set(box["m"]) == set(jm)
    assert box["m"]["loss_sum"].item() == pytest.approx(
        float(jm["loss_sum"]), rel=1e-5)
    for k in ("top1", "top5", "count"):
        assert box["m"][k].item() == float(jm[k]), k


def test_dense_row_matches_jax_train_step_under_adamw(tiny_pair):
    jcfg = tiny_pair["jax"][0]
    cfg = tiny_pair["bundle"].cfg
    x, y = tiny_pair["x"], tiny_pair["y"]
    jd = jvit.init_vit_params(jax.random.PRNGKey(2), jcfg)
    dtx = optax.adamw(1e-4)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jd,
                           alphas=None, arch=None, opt_state=dtx.init(jd))
    jstep = JS.make_train_step(jcfg, dtx, num_classes=jcfg.num_classes,
                               compute_dtype=jnp.float32, donate=False)
    dense = load_from_jax(ViT(cfg), np_tree(jd))
    init = {n: p.detach().clone() for n, p in dense.named_parameters()}
    call, box = PB.dense_call(cfg, dense, torch.from_numpy(x),
                              torch.from_numpy(y), torch.float32, None, CPU)
    for k in range(2):
        jstate, jm = jstep(jstate, x, y, jax.random.PRNGKey(1))
        assert call().item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = flatten_from_jax(np_tree(jstate.params))
    lr = 1e-4
    for n, p in box["s"].params.named_parameters():
        got = p.detach().numpy()
        if n.endswith("qkv.bias"):
            D = got.shape[0] // 3
            kpart = slice(D, 2 * D)
            assert np.abs(got[kpart] - init[n].numpy()[kpart]).max() \
                <= 2 * lr * 1.001, n
            got, ref = np.delete(got, np.s_[D:2 * D]), \
                np.delete(want[n], np.s_[D:2 * D])
        else:
            ref = want[n]
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5, err_msg=n)
    assert int(box["s"].opt_state.count) == int(jstate.step) == 2


def test_sgd0_row_leaves_params_and_alphas(tiny_pair):
    params, alphas, arch = tiny_pair["port"]
    bundle = tiny_pair["bundle"]
    scfg, _ = search_config(8)
    ztx = O.sgd(0.0)
    p0 = [t.detach().clone() for t in O.named_leaves(params,
                                                      alphas).values()]
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=ztx.init(O.named_leaves(params, alphas)))
    call, box = PB.search_call(bundle, scfg, ztx, state,
                               torch.from_numpy(tiny_pair["x"]),
                               torch.from_numpy(tiny_pair["y"]),
                               torch.float32, torch.Generator().manual_seed(1))
    for _ in range(2):
        assert torch.isfinite(call())
    assert box["m"]["grad_norm"].item() > 0
    for a, b in zip(p0, O.named_leaves(params, alphas).values()):
        assert torch.equal(a, b)
    assert int(box["s"].opt_state.count) == 2


@pytest.mark.parametrize("lr", [0.0, 0.3, "schedule"])
def test_sgd_matches_optax(lr):
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    sched = (lambda c: 0.1 * (0.5 ** c))
    jlr = (lambda c: 0.1 * (0.5 ** jnp.asarray(c, jnp.float32))) \
        if lr == "schedule" else lr
    jtx = optax.sgd(jlr)
    jst = jtx.init(g)
    tx = O.sgd(sched if lr == "schedule" else lr)
    leaves = {k: torch.zeros(v.shape) for k, v in g.items()}
    st = tx.init(leaves)
    for _ in range(3):
        ju, jst = jtx.update(g, jst, g)
        u, st = tx.update({k: torch.from_numpy(v) for k, v in g.items()},
                          st, leaves)
        for k in g:
            np.testing.assert_allclose(u[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6, err_msg=k)
    assert int(st.count) == 3


def test_no_mim_supernet_has_no_decoder_like_jax():
    jcfg, jspace = jax_supernet(TINY)[:2]
    jtree = jmim.init_mim_params(jax.random.PRNGKey(3), jcfg, jspace,
                                 mae=False)
    cfg, space = port_supernet(TINY, *jax_supernet(TINY)[2:])[:2]
    mine = init_mim_params(cfg, space, mae=False,
                           generator=torch.Generator().manual_seed(3))
    names = {n for n, _ in mine.named_parameters()}
    assert names == set(flatten_from_jax(np_tree(jtree)))
    assert not any(n.startswith("decoder") or n == "mask_token"
                   for n in names)
    full = {n for n, _ in init_mim_params(cfg, space).named_parameters()}
    assert "mask_token" in full and names < full


def test_perf_breakdown_main_tiny_prints_the_jax_keys(capsys):
    out = PB.main(["--tiny", "--device", "cpu", "--steps", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    src = jax_source("perf_breakdown.py")
    assert set(line) == dict_keys(src, "out")
    rows = {n.slice.value for n in ast.walk(src)
            if isinstance(n, ast.Subscript)
            and getattr(n.value, "id", None) == "rows"
            and isinstance(n.slice, ast.Constant)}
    # the JAX script skips augment_only off the TPU, as the tiny run does
    assert set(line["rows"]) == rows - {"augment_only"}
    for r in line["rows"].values():
        assert set(r) == {"img_s", "mfu"} and r["img_s"] > 0
    assert line["model"] == "tiny" and line["batch"] == 8


def test_tools_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main, argv in ((PB.main, ["--tiny"]), (AB.main, ["--batch", "2"]),
                       (SB.main, ["--batch", "2"]), (KP.main, [])):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)


# ---------------------------------------------------------------------------
# augment_breakdown
# ---------------------------------------------------------------------------

def staged(n=4, size=64, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                               dtype=np.uint8)


def test_augment_variant_names_are_the_jax_scripts():
    src = jax_source("augment_breakdown.py")
    names = [e.elts[0].value for n in ast.walk(src)
             if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", None) == "variants"
             for e in n.value.elts]
    assert [n for n, _ in AB.VARIANTS] == names and len(names) == 8


def test_full_variant_is_apply_train_augment_bit_for_bit():
    x = torch.from_numpy(staged(8))
    g = torch.Generator().manual_seed(5)
    d = A.draw_train_augment(g, 8, 64, 48, re_prob=0.5)
    assert bool(((d.ra_op >= len(A.PHOTO_OPS)) & d.ra_on).any())
    assert torch.equal(AB.make_pipeline(48)(x, d),
                       A.apply_train_augment(x, d, out_size=48))


def test_eval_like_variant_matches_jax():
    x = staged(3, 64)
    d = A.draw_train_augment(torch.Generator().manual_seed(0), 3, 64, 56)
    got = AB.make_pipeline(56, **dict(AB.VARIANTS)["resize only (eval-like)"]
                           )(torch.from_numpy(x), d)
    want = jax.vmap(lambda im: JA.normalize(JA.center_crop_resize(
        im.astype(jnp.float32), 56)))(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_shift_passes_match_jax(dtype):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (6, 40, 40, 3)).astype(np.float32)
    # one geometric layer a image: rotate (Paeth), shear_x, shear_y,
    # translate_x, translate_y, and a rotate that is off
    geo = np.array([0, 1, 2, 3, 4, 0])
    op = geo + len(A.PHOTO_OPS)
    mag = np.array([8.7, 9.0, 6.5, 9.6, 7.1, 9.0], np.float32)
    sign = np.array([1.0, -1.0, 1.0, 1.0, -1.0, 1.0], np.float32)
    on = np.array([True] * 5 + [False])
    jd = jnp.bfloat16 if dtype else None

    def one(im, g, m, sg, en):
        # the geometric slot of JAX's rand_augment, on given parameters
        H, W = im.shape[0], im.shape[1]
        frac = m / 10.0
        en = en.astype(jnp.float32)
        th = sg * frac * (30.0 * np.pi / 180.0)
        shear, trans = sg * frac * 0.3, sg * frac * 0.45
        is_rot = en * (g == 0)
        sx1 = is_rot * -jnp.tan(th / 2.0) + en * (g == 1) * shear
        sy_s = is_rot * jnp.sin(th) + en * (g == 2) * shear
        sx2 = is_rot * -jnp.tan(th / 2.0)
        tx, ty = en * (g == 3) * trans * W, en * (g == 4) * trans * H
        ys = jnp.arange(H, dtype=jnp.float32) - (H - 1) / 2.0
        xs = jnp.arange(W, dtype=jnp.float32) - (W - 1) / 2.0
        orig = im.dtype
        if jd is not None:
            im = im.astype(jd)
        im = JA._row_shift_frac(im, sx1 * ys + tx, 128.0)
        im = JA._col_shift_frac(im, sy_s * xs + ty, 128.0)
        im = JA._row_shift_frac(im, sx2 * ys, 128.0)
        return im.astype(orig)
    want = jax.vmap(one)(*map(jnp.asarray, (img, geo, mag, sign, on)))
    draws = types.SimpleNamespace(
        ra_op=torch.from_numpy(op)[:, None],
        ra_mag=torch.from_numpy(mag)[:, None],
        ra_sign=torch.from_numpy(sign)[:, None],
        ra_on=torch.from_numpy(on)[:, None])
    got = AB.ra_variant(torch.from_numpy(img), draws, photo=False,
                        geo_dtype=torch.bfloat16 if dtype else None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # the off layer only rounds: to uint8 values, after bf16's own rounding
    moved = np.abs(got.numpy() - img).reshape(6, -1).max(axis=1)
    assert (moved[:5] > 10).all() and moved[5] <= (1.0 if dtype else 0.5)


def test_augment_main_prints_variants_and_bf16_delta(capsys):
    out = AB.main(["--cpu", "--batch", "4", "--stage", "64",
                   "--out-size", "56", "--iters", "1"])
    text = capsys.readouterr().out
    assert list(out["ms"]) == [n for n, _ in AB.VARIANTS]
    assert all(ms > 0 for ms in out["ms"].values())
    assert all(f"{n:38s}" in text for n, _ in AB.VARIANTS)
    assert "bf16-geometry delta vs f32 (normalized units): mean" in text
    assert 0 <= out["delta"]["mean"] <= 0.017
    assert out["delta"]["max"] >= out["delta"]["p99"] >= 0


# ---------------------------------------------------------------------------
# swin_breakdown
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def swin_pair():
    jcfg = js.SwinCfg(**SWIN_CFG)
    tree = scaled(js.init_swin_params(jax.random.PRNGKey(0), jcfg))
    cfg = S.SwinCfg(**SWIN_CFG)
    return jcfg, tree, cfg, load_from_jax(S.Swin(cfg), np_tree(tree))


@pytest.mark.parametrize("run", ["full", "no_attn", "no_roll"])
def test_swin_ablations_match_jax_under_the_same_patches(run, swin_pair,
                                                         monkeypatch):
    jcfg, tree, cfg, params = swin_pair
    x = images(2, seed=4)
    if run == "no_attn":
        monkeypatch.setattr(js, "_window_attention",
                            lambda p, x, heads, w, rel_idx, mask, pack=1:
                            jvit.linear(p["proj"], x))
    elif run == "no_roll":
        shim = types.SimpleNamespace()
        shim.__dict__.update(jnp.__dict__)
        shim.roll = lambda x, shift, axis=None: x
        monkeypatch.setattr(js, "jnp", shim)
    want = np.asarray(js.swin_forward(tree, jnp.asarray(x), jcfg,
                                      compute_dtype=jnp.float32))
    monkeypatch.undo()
    with SB.patched(run):
        got = S.swin_forward(params, torch.from_numpy(x), cfg,
                             compute_dtype=torch.float32)
    close(got.detach().numpy(), want, run)
    if run != "full":
        full = S.swin_forward(params, torch.from_numpy(x), cfg,
                              compute_dtype=torch.float32)
        assert not torch.allclose(full, got)


def test_swin_stubs_restored_after_runs_and_raises(monkeypatch, capsys):
    real = (S._window_attention, S.shifted_windows)
    for run in ("no_attn", "no_roll"):
        with pytest.raises(ZeroDivisionError):
            with SB.patched(run):
                assert (S._window_attention, S.shifted_windows) != real
                1 / 0
        assert (S._window_attention, S.shifted_windows) == real

    import ofb_tpu_torch.models.registry as R
    create = R.create_model

    def small(name, device="cuda", **kw):
        b = create(name, device=device, **kw)
        b.cfg = S.SwinCfg(**dict(SWIN_CFG, drop_path_rate=0.1))
        return b
    monkeypatch.setattr(R, "create_model", small)
    out = SB.main(["--cpu", "--batch", "2", "--steps", "1"])
    assert list(out) == ["full", "no_attn", "no_roll"]
    assert all(v > 0 for v in out.values())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == {k: round(v, 1) for k, v in out.items()}
    assert (S._window_attention, S.shifted_windows) == real

    def boom(*a, **k):
        raise RuntimeError("step failed")
    monkeypatch.setattr(S, "window_softmax_attend", boom)
    with pytest.raises(RuntimeError, match="step failed"):
        SB.main(["--cpu", "--batch", "2", "--steps", "1"])
    assert (S._window_attention, S.shifted_windows) == real


# ---------------------------------------------------------------------------
# data_bench and kpad_probe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jpeg_folder(tmp_path_factory):
    from ofb_tpu_torch.scripts import make_imagefolder
    root = tmp_path_factory.mktemp("imf")
    make_imagefolder.main(["--root", str(root), "--classes", "2",
                           "--per-class", "3", "--val-per-class", "0",
                           "--min-size", "40", "--max-size", "72"])
    return str(root / "train")


def test_data_bench_keys_and_staging_match_jax(jpeg_folder, capsys):
    from PIL import Image
    from ofb_tpu.data import native as JN
    from ofb_tpu_torch.data import native as N
    argv = ["--root", jpeg_folder, "--n", "6", "--staging", "32", "--batch",
            "4", "--threads", "1", "2"]
    out = DB.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_run = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "data_bench.py")] + argv,
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert jax_run.returncode == 0, jax_run.stderr
    jline = json.loads(jax_run.stdout.strip().splitlines()[-1])
    assert set(line) == set(out) == set(jline)
    assert all(v > 0 for v in line.values())
    paths = sorted(str(p) for p in pathlib.Path(jpeg_folder).rglob("*.jpg"))
    for p in paths:
        with Image.open(p) as im:
            assert np.array_equal(resize_u8(im, 32), _ResizeU8(32)(im))
        if N.native_available():
            data = open(p, "rb").read()
            assert np.array_equal(N.stage_jpeg(data, 32),
                                  JN.stage_jpeg(data, 32))


def test_kpad_padded_chain_equals_unpadded_and_keys_match(capsys,
                                                         monkeypatch):
    x, w, xp, wp = KP.operands(24, 40, 56, KP.padded_k(40), CPU)
    assert KP.padded_k(384) == 512 and xp.shape == (24, 256)
    assert not xp[:, 40:].any() and not wp[40:].any()
    base = KP.chain(x.float(), w.float(), 3)
    padded = KP.chain(xp.float(), wp.float(), 3)
    assert torch.isfinite(base)
    np.testing.assert_allclose(padded.item(), base.item(), rtol=1e-5)
    monkeypatch.setattr(KP, "M_DEIT_S", 16)
    monkeypatch.setattr(KP, "ITERS", 1)
    lines = KP.main(["--device", "cpu"])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines and len(lines) == 5
    assert [(l["shape"], l["k"], l["n"]) for l in lines] == list(KP.SHAPES)
    want = dict_keys(jax_source("kpad_probe.py"))
    assert all(set(l) == want for l in lines)
