"""The port's examples (ofb_tpu_torch/examples/) and `dryrun.entry` against
the JAX package's `examples/` and `__graft_entry__.entry`, on the CPU.

The JAX compression story runs at import, so its `make_batch` is taken
from the file's source and run on JAX's own draws, which are handed to
the port's `make_batch_from` (exact). The examples run end to end at a
short length and must print their labelled lines. `entry()`: the port's
forward on the JAX entry's weights, converted, against the JAX entry's
logits (both bf16 compute: atol 2e-2 of the largest magnitude, the bf16
tolerance of the Swin test).
"""

import ast
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu_torch import dryrun
from ofb_tpu_torch.examples import compression_story as CS
from ofb_tpu_torch.examples import minimal_search as MS
from ofb_tpu_torch.models.from_jax import arch_from_jax, load_from_jax
from test_torch_port_from_jax import np_tree

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]


def jax_make_batch():
    """`make_batch` of examples/compression_story.py, from its source."""
    src = (REPO / "examples" / "compression_story.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "make_batch")
    ns = {"jax": jax, "jnp": jnp}
    exec(compile(ast.Module([fn], []), "compression_story.py", "exec"), ns)
    return ns["make_batch"]


@pytest.mark.parametrize("n,seed", [(16, 0), (64, 999)])
def test_make_batch_matches_jax_on_its_draws(n, seed):
    key = jax.random.PRNGKey(seed)
    jimgs, jlbl = jax_make_batch()(key, n)
    k1, k2 = jax.random.split(key)
    noise = np.array(jax.random.uniform(k1, (n, 32, 32, 3)))
    lbl = np.array(jax.random.randint(k2, (n,), 0, 8))
    imgs, lab = CS.make_batch_from(torch.from_numpy(noise),
                                   torch.from_numpy(lbl).long())
    assert imgs.dtype == torch.float32 and imgs.shape == (n, 32, 32, 3)
    np.testing.assert_array_equal(imgs.numpy(), np.asarray(jimgs))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlbl))
    # every class's bump is where its label says
    g = torch.Generator().manual_seed(1)
    imgs, lab = CS.make_batch(g, 8, "cpu")
    assert ((imgs > 0.3).any(dim=(1, 2, 3))).all()


def test_minimal_search_ends_ok(capsys):
    loss = MS.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "OK" and np.isfinite(loss)
    for label in ("dense model: ", "after 5 search steps: loss_total=",
                  "converged; events from last pass:", "exported: D=",
                  "finetune step on exported model: loss="):
        assert any(s.startswith(label) for s in out), label


def test_compression_story_short_run(capsys):
    res = CS.main(["--steps", "66", "--finetune-steps", "5", "--device",
                   "cpu"])
    out = capsys.readouterr().out
    for label in ("supernet acc after search: ", "exported: D=",
                  "exported (no finetune): ",
                  "exported + 5 finetune steps: "):
        assert label in out, label
    story = re.search(r"STORY: supernet ([\d.]+)% -> hard-pruned ([\d.]+)% "
                      r"-> finetuned ([\d.]+)% at (\d+)% FLOPs", out)
    assert story, out
    assert [float(story.group(i)) for i in (1, 2, 3)] == [
        round(res[k], 1) for k in ("supernet", "exported", "finetuned")]
    assert 0 < res["flops_pct"] <= 100
    assert len(res["blocks"]) == CS.CFG["depth"]
    assert res["params"][1] <= res["params"][0]


def test_examples_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (MS.main, CS.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.entry()


def test_entry_matches_jax_entry():
    import __graft_entry__ as G
    jfn, (jp, ja, jarch, jx) = G.entry()
    want = np.asarray(jfn(jp, ja, jarch, jx))
    fn, (params, alphas, arch, x) = dryrun.entry("cpu")
    assert x.shape == (8, 224, 224, 3) and not x.any()
    load_from_jax(params, np_tree(jp))
    load_from_jax(alphas, np_tree(ja))
    with torch.no_grad():
        got = fn(params, alphas, arch_from_jax(jarch), x)
    assert got.shape == (8, 1000) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2 * scale)
