"""(c) ofb_tpu_torch/ops/attention.py against ofb_tpu/ops/pallas_attention.py.

On the CPU the wrappers run the plain twins of the CUDA kernels, so this
holds the twins (forward, backward and the autograd Function around them)
against JAX's reference path, its Pallas kernel pair in interpret mode,
and `jax.grad` through the Pallas custom VJP. The CUDA kernels themselves
are held against the same twins on the card by chip_smoke.py.

Tolerance: fp32 everywhere; the frameworks sum in other orders, so values
and gradients agree to rtol 1e-5 / atol 2e-6 (the JAX package's own
Pallas test allows 2e-5 / 5e-5 between its two paths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.ops import pallas_attention as JA
from ofb_tpu_torch.ops import attention as A

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 2e-6


def qkv(B=2, N=17, H=3, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, N, H, d)) * 0.5).astype(np.float32)
            for _ in range(3)]


def close(a, b):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 17, 3, 16), (1, 24, 2, 24),
                                   (2, 9, 1, 40)])
def test_forward_matches_jax_reference_and_pallas(shape):
    q, k, v = qkv(*shape)
    scale = 0.25
    ref = JA.fused_mha(q, k, v, scale, force=False)
    pallas = JA.fused_mha(q, k, v, scale, force=True, interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    close(A.fused_mha(tq, tk, tv, scale), ref)
    close(A.fused_mha(tq, tk, tv, scale), pallas)
    qs = (q * scale).astype(np.float32)
    close(A.mha_reference_prescaled(torch.from_numpy(qs), tk, tv),
          JA._mha_reference_prescaled(qs, k, v))
    o, lse = A.attention_fwd(torch.from_numpy(qs), tk, tv)
    close(o, pallas)
    s = np.einsum("bnhd,bmhd->bhnm", qs, k)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale", [0.25, 0.125])
def test_gradients_match_jax_grad(scale):
    q, k, v = qkv(seed=1)
    cot = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(JA.fused_mha(q, k, v, scale, force=True,
                                    interpret=True) * cot)

    gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (A.fused_mha(tq, tk, tv, scale) * torch.from_numpy(cot)).sum().backward()
    close(tq.grad, gq)
    close(tk.grad, gk)
    close(tv.grad, gv)


def test_backward_twin_matches_pallas_bwd_kernel():
    q, k, v = qkv(seed=3)
    do = qkv(seed=4)[0]
    want = JA._mha_bwd_pallas(*(x.transpose(0, 2, 1, 3) for x in (q, k, v, do)),
                              interpret=True)
    got = A.attention_bwd_reference(*map(torch.from_numpy, (q, k, v, do)))
    for g, w in zip(got, want):
        close(g, np.asarray(w).transpose(0, 2, 1, 3))


def test_strided_views_of_qkv_and_runtime_scale():
    """The search step hands in views of the (B, N, 3, H, d) qkv buffer and
    a 0-d scale tensor that prune events rewrite."""
    rng = np.random.default_rng(5)
    buf = torch.from_numpy(rng.normal(size=(2, 17, 3, 2, 16)).astype(np.float32))
    q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
    assert not k.is_contiguous()
    s1 = A.fused_mha(q, k, v, torch.tensor(0.25))
    s2 = A.fused_mha(q, k, v, torch.tensor(0.5))
    assert not torch.allclose(s1, s2)
    close(s1, JA.fused_mha(*(x.numpy() for x in (q, k, v)), 0.25,
                           force=False))


def test_cpu_path_counts_no_launch_and_bad_inputs_raise():
    A.reset_launch_counts()
    q, k, v = map(torch.from_numpy, qkv())
    A.fused_mha(q, k, v, 0.25)
    assert A.attention_fwd.launches == 0 and A.attention_bwd.launches == 0
    with pytest.raises(ValueError):
        A._check(q[..., :12], k[..., :12], v[..., :12])       # d % 8 != 0
    with pytest.raises(TypeError):
        A._check(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        A._check(q, k[:, :5], v)
