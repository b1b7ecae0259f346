"""Above 256 tokens: the streaming attention body's shapes, and the
finetune CLI at a larger input size than the subnet was searched at.

* A tiny dense ViT at 290 tokens (68 x 68 images, patch 4, 2 blocks; more
  tokens than the resident body takes, as DeiT at 384 pixels has 577),
  carried over from the JAX package by `from_jax.py`: logits and the
  gradients of every parameter against `ofb_tpu/models/vit.py:vit_forward`
  and `jax.grad`, fp32, rtol 1e-4 / atol 2e-5 (two blocks of sums in
  another order; the attention twins run on the CPU).
* `cli.finetune --input-size 48` on a tiny exported subnet searched at 32
  (patch 8: 16 + 1 tokens -> 36 + 1): the run trains and evaluates at 48,
  and the pos-embed it starts from equals JAX's
  `ofb_tpu/models/pos_embed.py:interpolate_pos_embed` of the exported one
  to atol 1e-5 (test_torch_port_export's tolerance for the resize: JAX's
  resize sums the same weights in another order). The run
  takes lr 0, so the saved pos-embed is the one it started from. The JAX
  CLI (`scripts/finetune.py:248-257`) keeps the checkpoint's img_size, so
  its resize never runs; the port resizes, as the reference's
  `finetune.py:331-349` does.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.models import pos_embed as jpe
from ofb_tpu.models import vit as jvit
from ofb_tpu_torch.cli import finetune
from ofb_tpu_torch.cli.common import run_main
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.models.from_jax import flatten_from_jax, load_from_jax
from ofb_tpu_torch.models.vit import ModelCfg, ViT, vit_forward
from ofb_tpu_torch.ops import attention as A
from test_torch_port_from_jax import np_tree

torch.set_num_threads(1)
WIDE = dict(img_size=68, patch_size=4, num_classes=10, embed_dim=48,
            depth=2, num_heads=3, mlp_ratio=2.0, drop_path_rate=0.0)


def test_dense_vit_above_256_tokens_matches_jax():
    jcfg = jvit.ModelCfg(**WIDE)
    cfg = ModelCfg(**WIDE)
    N = cfg.num_patches + cfg.num_tokens
    assert N == 290 and A.attention_body(N, cfg.hd, torch.bfloat16).name \
        == "streaming"
    jparams = jvit.init_vit_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(2, 68, 68, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 10)).astype(np.float32)

    def loss(p):
        return jnp.sum(jvit.vit_forward(p, x, jcfg,
                                        compute_dtype=jnp.float32) * cot)

    jlogits = jvit.vit_forward(jparams, x, jcfg, compute_dtype=jnp.float32)
    jgrads = flatten_from_jax(np_tree(jax.grad(loss)(jparams)))
    model = load_from_jax(ViT(cfg), np_tree(jparams))
    logits = vit_forward(model, torch.from_numpy(x), cfg,
                         compute_dtype=torch.float32)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=2e-5)
    (logits * torch.from_numpy(cot)).sum().backward()
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads)
    for n, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], rtol=1e-4,
                                   atol=2e-5, err_msg=n)


def test_finetune_cli_resizes_the_pos_embed_to_the_input_size(tmp_path):
    cfg = ModelCfg(img_size=32, patch_size=8, num_classes=1000, embed_dim=32,
                   depth=2, num_heads=2, mlp_ratio=2.0,
                   block_overrides=((2, 16, 48), (1, 24, 40)))
    model = ViT(cfg, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():                 # a pos-embed with structure
        model.pos_embed.normal_(generator=torch.Generator().manual_seed(6))
    xdir = str(tmp_path / "exported")
    ck.save_checkpoint(xdir, params=model, meta={
        "exported": True, "model_cfg": dataclasses.asdict(cfg)})
    fdir = str(tmp_path / "ft")
    state, text = run_main(finetune, [
        "--data-set", "SYNTHETIC", "--finetune", xdir, "--input-size", "48",
        "--epochs", "1", "--batch-size", "1024", "--lr", "0",
        "--warmup-lr", "0", "--min-lr", "0", "--device", "cpu",
        "--compute-dtype", "float32", "--num_workers", "0",
        "--output_dir", fdir])
    row = [json.loads(x) for x in open(os.path.join(fdir, "log.txt"))
           if x.startswith("{")][-1]
    assert np.isfinite(row["train_loss"])
    meta = json.load(open(os.path.join(fdir, "best", "meta.json")))
    assert meta["model_cfg"]["img_size"] == 48
    saved_cfg = ck.model_cfg_from_meta(meta["model_cfg"], ModelCfg)
    saved = ViT(saved_cfg)
    ck.load_checkpoint(os.path.join(fdir, "best"), params=saved)
    want = jpe.interpolate_pos_embed(
        jnp.asarray(model.pos_embed.detach().numpy()), 36, 1)
    assert saved.pos_embed.shape == (1, 37, 32)
    np.testing.assert_allclose(saved.pos_embed.detach().numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(saved.blocks[1].attn.qkv.weight.detach()
                                  .numpy(),
                                  model.blocks[1].attn.qkv.weight.detach()
                                  .numpy())
