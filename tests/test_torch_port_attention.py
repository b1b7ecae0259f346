"""(c) ofb_tpu_torch/ops/attention.py against ofb_tpu/ops/pallas_attention.py.

On the CPU the wrappers run the plain twins of the CUDA kernels, so this
holds the twins (forward, backward and the autograd Function around them)
against JAX's reference path, its Pallas kernel pair in interpret mode,
and `jax.grad` through the Pallas custom VJP. The CUDA kernels themselves
(two bodies, resident and general) are held against the same twins on the
card by chip_smoke.py; here the choice between the bodies, the padding and
the shared memory the resident one asks for are checked, since they are
plain Python.

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
BF16, F32 = torch.bfloat16, torch.float32


def qkv(B=2, N=17, H=3, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, N, H, d)) * 0.5).astype(np.float32)
            for _ in range(3)]


def close(a, b):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 17, 3, 16), (1, 24, 2, 24),
                                   (2, 9, 1, 40), (1, 12, 2, 56),
                                   (1, 197, 1, 72)])
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


@pytest.mark.parametrize("shape", [(1, 12, 2, 56), (1, 197, 1, 72)])
def test_backward_twin_matches_pallas_bwd_kernel_at_wider_heads(shape):
    """The exported subnets' widest 8 * odd head dim and one past 64 (the
    resident body's two-kernel backward), at DeiT's 197 tokens."""
    q, k, v = qkv(*shape, seed=8)
    do = qkv(*shape, seed=9)[0]
    want = JA._mha_bwd_pallas(*(x.transpose(0, 2, 1, 3) for x in (q, k, v, do)),
                              interpret=True)
    got = A.attention_bwd_reference(*map(torch.from_numpy, (q, k, v, do)))
    for g, w in zip(got, want):
        close(g, np.asarray(w).transpose(0, 2, 1, 3))


def _pad16(x):
    """x with its head dim zero-padded to the next multiple of 16."""
    d = x.shape[-1]
    return torch.nn.functional.pad(x, (0, -d % 16))


@pytest.mark.parametrize("N,d", [(17, 8), (33, 24), (197, 40), (70, 56),
                                 (197, 72), (9, 120)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_zero_padded_head_dim_reproduces_the_twins(N, d, dtype):
    """The invariant the resident kernels rely on for head dims 8 * odd:
    q, k, v and do zero-padded to d16 = 16 * ceil(d / 16) give, sliced back
    to d columns, the forward and backward of the unpadded inputs, and
    zeros in the padded columns of every output. fp32 to the file's
    tolerance; bf16 to 1e-2, since p and ds are rounded to bf16 and a score
    that moves by one fp32 step (the sums over d run in another order) may
    round the other way."""
    q, k, v = (torch.from_numpy(x).to(dtype) for x in qkv(2, N, 2, d, seed=10))
    do = torch.from_numpy(qkv(2, N, 2, d, seed=11)[0]).to(dtype)
    qp, kp, vp, dop = map(_pad16, (q, k, v, do))
    assert qp.shape[-1] % 16 == 0 and qp.shape[-1] - d in (0, 8)
    o, lse = A.attention_fwd_reference(q, k, v)
    op, lsep = A.attention_fwd_reference(qp, kp, vp)
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == F32 else dict(rtol=1e-2,
                                                               atol=1e-2)
    torch.testing.assert_close(op[..., :d], o, **tol)
    torch.testing.assert_close(lsep, lse, rtol=RTOL, atol=ATOL)
    got = A.attention_bwd_reference(qp, kp, vp, dop)
    for gp, g in zip(got, A.attention_bwd_reference(q, k, v, do)):
        torch.testing.assert_close(gp[..., :d], g, **tol)
        assert not gp[..., d:].any()
    assert not op[..., d:].any()


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



@pytest.mark.parametrize("N,d,dtype,aligned,want", [
    (197, 64, BF16, True, "resident"),       # DeiT-T/S/B on the search step
    (197, 32, BF16, True, "resident"),
    (50, 32, BF16, True, "resident"),        # a Swin window and its cls
    (256, 128, BF16, True, "resident"),      # the largest it takes
    (1, 16, BF16, True, "resident"),
    (1, 8, BF16, True, "resident"),          # the smallest
    (197, 24, BF16, True, "resident"),       # d = 8 * odd, padded to 32
    (197, 8, BF16, True, "resident"),
    (197, 40, BF16, True, "resident"),       # exported subnets' head dims
    (197, 56, BF16, True, "resident"),
    (197, 72, BF16, True, "resident"),       # padded to 80, 128-column tiles
    (257, 64, BF16, True, "general"),        # more keys than one pass holds
    (257, 40, BF16, True, "general"),
    (197, 64, F32, True, "general"),         # fp32 stays off the tensor cores
    (197, 40, F32, True, "general"),
    (197, 64, BF16, False, "general"),       # rows not on 16 bytes
    (197, 24, BF16, False, "general"),       # unaligned 8 * odd views
    (197, 56, BF16, False, "general"),
])
def test_body_choice_by_shape_type_and_alignment(N, d, dtype, aligned, want):
    body = A.attention_body(N, d, dtype, aligned)
    assert body.name == want
    if want == "general":
        assert body == A.Body("general", 0, 0, 0)


@pytest.mark.parametrize("N,keys", [(1, 64), (64, 64), (65, 128), (128, 128),
                                    (192, 192), (193, 208), (197, 208),
                                    (208, 208), (209, 256), (256, 256)])
def test_resident_forward_pads_keys(N, keys):
    body = A.attention_body(N, 64, BF16)
    assert body.padded_keys == keys >= N and keys % 16 == 0


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_resident_shared_memory_fits_a_block(d):
    """Every shape the resident body takes asks for no more shared memory
    than a Hopper block may have, and for what the kernels lay out: K and V
    (or Q and dO) whole, the streamed 64-row tiles, the row terms, 1024
    bytes of slack. Head dims 8 * odd lay out as the next multiple of 16."""
    dp = 64 if d <= 64 else 128
    for N in range(1, 257):
        body = A.attention_body(N, d, BF16)
        assert body.name == "resident"
        assert 0 < body.smem_fwd <= A.MAX_SMEM and 0 < body.smem_bwd <= A.MAX_SMEM
        assert body.smem_fwd == 2 * body.padded_keys * dp * 2 + 2 * 64 * dp * 2 + 1024
        rows = -(-N // 16) * 16
        assert body.smem_bwd >= 2 * rows * dp * 2 + 4 * 64 * dp * 2
    deit = A.attention_body(197, 64, BF16)
    assert (deit.smem_fwd, deit.smem_bwd) == (70656, 191488)
    # two forward blocks fit an SM's 228 KB (1 KB reserved a block); the
    # fused backward holds five operands and runs one block an SM
    assert 2 * (deit.smem_fwd + 1024) <= 228 * 1024


def test_alignment_of_views():
    buf = torch.zeros((2, 17, 3, 2, 16), dtype=BF16)
    assert all(A._aligned16(buf[:, :, i]) for i in range(3))
    assert not A._aligned16(buf[:, :, 0, :, 4:12])       # starts 8 bytes in
    odd = torch.zeros((2, 17, 2, 20), dtype=BF16)[..., :16]
    assert not A._aligned16(odd)                         # head stride 20


def test_cpu_tensors_run_the_twins_whatever_body_is_named():
    A.reset_launch_counts()
    q, k, v = (torch.from_numpy(x).to(BF16) for x in qkv(2, 197, 2, 64, seed=6))
    do = torch.from_numpy(qkv(2, 197, 2, 64, seed=7)[0]).to(BF16)
    want_o, want_lse = A.attention_fwd_reference(q, k, v)
    for body in (None, "resident", "general"):
        o, lse = A.attention_fwd(q, k, v, body=body)
        assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
        got = A.attention_bwd(q, k, v, o, lse, do, body=body)
        for g, w in zip(got, A.attention_bwd_reference(q, k, v, do)):
            assert torch.equal(g, w)
    for w in (A.attention_fwd, A.attention_bwd):
        assert w.launches == 0 and w.by_body == {"resident": 0, "general": 0}


def test_a_named_body_that_does_not_fit_raises_before_any_launch():
    A.reset_launch_counts()
    q, k, v = map(torch.from_numpy, qkv())               # fp32
    with pytest.raises(ValueError, match="resident"):
        A._launch(A.attention_fwd, "fwd", "resident", [q, k, v], [],
                  tuple(q.shape))
    with pytest.raises(ValueError, match="no attention body"):
        A._launch(A.attention_fwd, "fwd", "flash", [q, k, v], [],
                  tuple(q.shape))
    assert A.attention_fwd.launches == 0


def test_every_body_has_its_source():
    from ofb_tpu_torch.ops import cuda_build
    for lib, entry, _, _ in A._ENTRIES.values():
        src = cuda_build.CSRC / cuda_build.SOURCES[lib]
        assert f'extern "C" int {entry}(' in src.read_text()
    for header in cuda_build._HEADERS:
        assert (cuda_build.CSRC / header).is_file()
