"""(c) ofb_tpu_torch/ops/attention.py against ofb_tpu/ops/pallas_attention.py.

On the CPU the wrappers run the plain twins of the CUDA kernels, so this
holds the twins (forward, backward and the autograd Function around them)
against JAX's reference path, its Pallas kernel pair in interpret mode,
and `jax.grad` through the Pallas custom VJP, at DeiT's 197 tokens, at
the streaming body's counts above 256 (577 = DeiT at 384 pixels) and at
head dims that are not a multiple of 8 (4, 12, 21, 36), which JAX's
`fused_mha` takes and only the unaligned body (bf16) and the general body
(fp32) serve; and a tiny subnet with such heads through the dense train and
eval steps against JAX's. The CUDA kernels themselves (four bodies:
resident, streaming, unaligned and general) are held
against the same twins on the card by chip_smoke.py; here the choice
between the bodies, the padding and the shared memory each body asks for
are checked, since they are plain Python.

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
    """Every head dim in [1, 128] passes `_check`, as JAX's `fused_mha`
    takes any; 0 and 136 raise."""
    A.reset_launch_counts()
    q, k, v = map(torch.from_numpy, qkv())
    A.fused_mha(q, k, v, 0.25)
    assert A.attention_fwd.launches == 0 and A.attention_bwd.launches == 0
    for d in (4, 6, 12, 36):
        x = torch.zeros((2, 17, 3, d))
        assert A._check(x, x[:], x[:]) == (2, 17, 3, d)
    for d in (0, 136):
        x = torch.zeros((2, 17, 3, d))
        with pytest.raises(ValueError, match="head dim"):
            A._check(x, x, x)
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
    (257, 64, BF16, True, "streaming"),      # more keys than one pass holds
    (257, 40, BF16, True, "streaming"),
    (577, 64, BF16, True, "streaming"),      # DeiT at 384 pixels
    (577, 24, BF16, True, "streaming"),      # its subnets' 8 * odd heads
    (1025, 120, BF16, True, "streaming"),
    (577, 64, F32, True, "general"),         # fp32 at any token count
    (577, 64, BF16, False, "unaligned"),     # unaligned at any token count
    (1025, 64, BF16, False, "unaligned"),
    (197, 64, F32, True, "general"),         # fp32 stays off the tensor cores
    (197, 40, F32, True, "general"),
    (197, 64, BF16, False, "unaligned"),     # rows not on 16 bytes
    (197, 24, BF16, False, "unaligned"),     # unaligned 8 * odd views
    (197, 56, BF16, False, "unaligned"),
    (197, 128, BF16, False, "unaligned"),    # the widest head, unaligned
    (197, 1, BF16, True, "unaligned"),       # the narrowest head dim
    (197, 127, BF16, True, "unaligned"),     # the widest off a multiple of 8
    (197, 1, F32, True, "general"),
] + [(N, d, dtype, aligned, "unaligned" if dtype == BF16 else "general")
     for N, d in ((197, 4), (197, 6), (197, 12), (577, 36), (17, 60),
                  (197, 84))                 # head dims off multiples of 8
     for dtype in (BF16, F32) for aligned in (True, False)])
def test_body_choice_by_shape_type_and_alignment(N, d, dtype, aligned, want):
    body = A.attention_body(N, d, dtype, aligned)
    assert body.name == want
    if want in ("unaligned", "general"):
        assert body.padded_keys == 64 * -(-N // 64)
        assert 0 < body.smem_fwd <= A.MAX_SMEM
        assert 0 < body.smem_bwd <= A.MAX_SMEM


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


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_streaming_shared_memory_fits_a_block(d):
    """Every head dim the streaming body takes, at any token count, asks
    for no more shared memory than a Hopper block may have, and for what
    its kernels lay out (csrc/attention_*_streaming.cu): 64-row tiles of a
    64-column panel and a tail of 0, 16, 32 or 64 columns, 8-byte mbarriers
    and 1024 bytes of slack. The forward holds two query buffers of two
    tiles and a ring of 128-key K, V stages (4, 4, 3 and 2 stages by tail);
    the dq kernel q, do and o of two consumer warpgroups in two buffers
    (one at a 64-column tail) and a ring of 64-key K, V stages (6, 4, 3,
    3); the dk/dv kernel k and v in as many buffers and a ring of Q, dO and
    1024 bytes of their lse and delta (8, 6, 4, 4). Head dims 8 * odd lay
    out as the next multiple of 16; the keys walk in whole tiles of 64."""
    tw = A.streaming_tail(d)
    tile = 64 * 2 * (64 + tw)
    fwd_stages, dq_stages, kv_stages = {0: (4, 6, 8), 16: (4, 4, 6),
                                        32: (3, 3, 4), 64: (2, 3, 4)}[tw]
    buffers = 2 if tw <= 32 else 1
    fwd = 4 * tile + 2 * (2 * tile) * fwd_stages + 8 * (4 + 3 * fwd_stages) \
        + 1024
    dq = 6 * buffers * tile + 2 * tile * dq_stages + 8 * (4 + 2 * dq_stages) \
        + 1024
    dkdv = 4 * buffers * tile + (2 * tile + 1024) * kv_stages \
        + 8 * (4 + 2 * kv_stages) + 1024
    for N in range(257, 4098, 20):
        body = A.attention_body(N, d, BF16)
        assert body.name == "streaming"
        assert body.padded_keys == 64 * -(-N // 64) >= N
        assert (body.smem_fwd, body.smem_bwd) == (fwd, max(dq, dkdv))
        assert 0 < body.smem_fwd <= A.MAX_SMEM
        assert 0 < body.smem_bwd <= A.MAX_SMEM
    deit = A.attention_body(577, 64, BF16)
    assert (deit.smem_fwd, deit.smem_bwd) == (164992, 205984)
    # one block an SM: a producer and two consumer warpgroups (384 threads
    # at 168 registers) take the SM's registers, and either kernel's shared
    # memory fits its 228 KB (1 KB reserved a block)
    assert deit.smem_fwd + 1024 <= 228 * 1024
    assert deit.smem_bwd + 1024 <= 228 * 1024


@pytest.mark.parametrize("d,tail", [(d, 0) for d in range(8, 65, 8)]
                         + [(72, 16), (80, 16), (88, 32), (96, 32),
                            (104, 64), (112, 64), (120, 64), (128, 64)])
def test_streaming_tail_columns(d, tail):
    """The streaming body's tiles: d16 = 16 * ceil(d / 16) columns as a
    64-column panel and a tail of d16 - 64 columns where a 32- or 64-byte
    swizzle holds it (16: ViT-H/14's d = 80; 32), else a second 64-column
    panel, so d = 80 runs in 80 columns, not 128."""
    assert A.streaming_tail(d) == tail
    d16 = 16 * -(-d // 16)
    assert 64 + tail >= d16 and (tail in (0, 64) or 64 + tail == d16)


@pytest.mark.parametrize("d", range(1, 129))
def test_unaligned_shared_memory_fits_a_block(d):
    """Every head dim the unaligned body takes, at any token count, asks
    for no more shared memory than a Hopper block may have, and for what
    its kernels lay out (csrc/attention_*_unaligned.cu): 64-row bf16 tiles
    of 64 columns up to d16 = 16 * ceil(d / 16) = 64, else 128; a streamed
    operand in a tile and a second slot, its next tile or the staging area
    of its next tile (64 rows of DP / 8 + 1 aligned 16-byte chunks); the
    forward's q, k and v; the dk/dv kernel's k, v, q and do with the lse and
    delta of two query tiles (the dq kernel's q, do, k and v with those of
    its own 64 rows take less); 1024 bytes of slack. Keys walk in tiles of
    64. At every head dim two blocks of each kernel fit an SM's 228 KB (1
    KB reserved a block)."""
    dp = 64 if 16 * -(-d // 16) <= 64 else 128
    tile, staged = 64 * dp * 2, 64 * (dp // 8 + 1) * 16
    fwd = tile + 2 * (tile + staged) + 1024
    bwd = 2 * tile + 2 * (tile + staged) + 4 * 64 * 4 + 1024
    for N in (1, 17, 197, 577, 1025):
        for aligned in (True, False):
            body = A.attention_body(N, d, BF16, aligned)
            if d % 8 == 0 and aligned:
                assert body.name in ("resident", "streaming")
                continue
            assert body.name == "unaligned"
            assert body.padded_keys == 64 * -(-N // 64) >= N
            assert (body.smem_fwd, body.smem_bwd) == (fwd, bwd)
            assert 0 < body.smem_fwd <= A.MAX_SMEM
            assert 0 < body.smem_bwd <= A.MAX_SMEM
            assert 2 * (body.smem_fwd + 1024) <= 228 * 1024
            assert 2 * (body.smem_bwd + 1024) <= 228 * 1024
    if d == 64:
        assert (fwd, bwd) == (44032, 53248)


@pytest.mark.parametrize("d", range(1, 129))
def test_general_shared_memory_fits_a_block(d):
    """Every head dim the general body takes asks for no more shared memory
    than a Hopper block may have, and for what its fp32 kernels lay out
    (csrc/attention_common.cuh): tiles of 32 * ceil(d / 32) fp32 columns;
    the forward's q (128 resident rows up to d = 64, 64 above), two
    buffers of k and v and half a key tile of p; the dq kernel's q and do
    (64 resident rows), two buffers of k and v and a 64-column ds tile;
    the dk/dv kernel's k and v, two buffers of q and do, their lse and
    delta, the p / ds tile. At d = 64 two blocks of each kernel fit an
    SM's 228 KB (1 KB reserved a block)."""
    dp = 32 * -(-d // 32)
    bm = 128 if d <= 64 else 64
    body = A.attention_body(197, d, F32)
    assert body.name == "general" and body.padded_keys == 256
    assert body.smem_fwd == 4 * (bm * dp + 2 * 2 * 64 * dp + bm * 32)
    assert body.smem_bwd == 4 * (2 * 64 * dp + 2 * 2 * 64 * dp + 64 * 64
                                 + 4 * 64)
    assert 0 < body.smem_fwd <= A.MAX_SMEM and 0 < body.smem_bwd <= A.MAX_SMEM
    if d == 64:
        assert (body.smem_fwd, body.smem_bwd) == (114688, 115712)
        assert 2 * (body.smem_fwd + 1024) <= 228 * 1024
        assert 2 * (body.smem_bwd + 1024) <= 228 * 1024


def _twins_match_jax_and_pallas(shape, seed, scale):
    """The twins through `fused_mha` against JAX's reference path and its
    Pallas kernel in interpret mode; the backward twin against the Pallas
    backward kernel and `jax.grad` through the custom VJP."""
    q, k, v = qkv(*shape, seed=seed)
    cot = qkv(*shape, seed=seed + 1)[0]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = A.fused_mha(tq, tk, tv, scale)
    close(got, JA.fused_mha(q, k, v, scale, force=False))
    close(got, JA.fused_mha(q, k, v, scale, force=True, interpret=True))
    qs = (q * scale).astype(np.float32)
    want = JA._mha_bwd_pallas(*(x.transpose(0, 2, 1, 3)
                                for x in (qs, k, v, cot)), interpret=True)
    twin = A.attention_bwd_reference(*map(torch.from_numpy, (qs, k, v, cot)))
    for g, w in zip(twin, want):
        close(g, np.asarray(w).transpose(0, 2, 1, 3))

    def loss(q, k, v):
        return jnp.sum(JA.fused_mha(q, k, v, scale, force=True,
                                    interpret=True) * cot)

    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (A.fused_mha(tq, tk, tv, scale) * torch.from_numpy(cot)).sum().backward()
    for t, g in zip((tq, tk, tv), grads):
        close(t.grad, g)


@pytest.mark.parametrize("shape", [(2, 197, 2, 12), (1, 577, 2, 36),
                                   (3, 17, 1, 4), (1, 577, 2, 21)])
def test_twins_at_head_dims_off_multiples_of_8_match_jax_and_pallas(shape):
    """Head dims that only the unaligned body (bf16) and the general body
    (fp32) serve (a tiny search exports 4 .. 16; the search grids 12, 20,
    36, ..): DeiT's 197 tokens, DeiT at 384 pixels at an even and at an odd
    head dim (whose rows start on 2 bytes only), and a ragged count,
    forward and backward against JAX as above 256 tokens, fp32."""
    _twins_match_jax_and_pallas(shape, 14, 0.3)


@pytest.mark.parametrize("shape", [(1, 577, 2, 40), (1, 300, 1, 64)])
def test_twins_above_256_tokens_match_jax_and_pallas(shape):
    """The streaming body's token counts: DeiT at 384 pixels with an
    exported subnet's 8 * odd head, and a ragged count (300 = 4 x 64 +
    44). Forward against JAX's reference path and its Pallas kernel in
    interpret mode; backward against the Pallas backward kernel and
    `jax.grad` through the custom VJP."""
    _twins_match_jax_and_pallas(shape, 12, 0.2)


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
    for body in (None, "resident", "streaming", "unaligned", "general"):
        o, lse = A.attention_fwd(q, k, v, body=body)
        assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
        got = A.attention_bwd(q, k, v, o, lse, do, body=body)
        for g, w in zip(got, A.attention_bwd_reference(q, k, v, do)):
            assert torch.equal(g, w)
    for w in (A.attention_fwd, A.attention_bwd):
        assert w.launches == 0 and w.by_body == {
            "resident": 0, "streaming": 0, "unaligned": 0, "general": 0}


def test_a_named_body_that_does_not_fit_raises_before_any_launch():
    """The resident, the streaming and the unaligned bodies take no fp32,
    the general body (fp32 only) no bf16."""
    A.reset_launch_counts()
    q, k, v = map(torch.from_numpy, qkv())               # fp32
    for body in ("resident", "streaming", "unaligned"):
        with pytest.raises(ValueError, match=body):
            A._launch(A.attention_fwd, "fwd", body, [q, k, v], [],
                      tuple(q.shape))
    for t in ((q, k, v), qkv(2, 17, 3, 20)):             # resident, unaligned
        t = [torch.as_tensor(x).to(BF16) for x in t]
        with pytest.raises(ValueError, match="general"):
            A._launch(A.attention_fwd, "fwd", "general", t, [],
                      tuple(t[0].shape))
    with pytest.raises(ValueError, match="no attention body"):
        A._launch(A.attention_fwd, "fwd", "flash", [q, k, v], [],
                  tuple(q.shape))
    assert A.attention_fwd.launches == 0


def test_every_body_has_its_source():
    from ofb_tpu_torch.ops import cuda_build
    assert {b for _, b in A._ENTRIES} == set(A.BODIES) \
        == {"resident", "streaming", "unaligned", "general"}
    for (which, body), (lib, _) in A._ENTRIES.items():
        src = cuda_build.CSRC / cuda_build.SOURCES[lib]
        assert f'extern "C" int ofb_{lib}(' in src.read_text()
        assert which in lib and (body in lib or body == "general")
    for header in cuda_build._HEADERS:
        assert (cuda_build.CSRC / header).is_file()


# a tiny exported subnet whose head dims are not multiples of 8, as a
# `--tiny-test` search exports them (its head dim 16 searches 4, 6, .., 16)
SMALL_HEADS = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=32,
                   depth=4, num_heads=2, mlp_ratio=2.0, drop_path_rate=0.0,
                   block_overrides=((2, 4, 48), (3, 6, 40), (2, 12, 64),
                                    (1, 36, 32)))


def test_small_heads_subnet_train_and_eval_steps_match_jax():
    """The port's dense train step (2 steps, layer-decay AdamW, label
    smoothing) and eval step on that subnet against `ofb_tpu`'s, fp32, from
    the same weights: every block's attention goes to the unaligned body in
    bf16 and to the general body in fp32. Tolerances as in test_torch_port_finetune_step.py: loss
    rel 1e-5, params atol 2e-5, eval loss rel 1e-4."""
    from ofb_tpu.core import lr_decay as JL
    from ofb_tpu.core import steps as JS
    from ofb_tpu.models import vit as jvit
    from ofb_tpu_torch.core import lr_decay as LD
    from ofb_tpu_torch.core import steps as S
    from ofb_tpu_torch.models.from_jax import flatten_from_jax, to_jax
    from ofb_tpu_torch.models.vit import ModelCfg, ViT
    from test_torch_port_from_jax import np_tree

    cfg, jcfg = ModelCfg(**SMALL_HEADS), jvit.ModelCfg(**SMALL_HEADS)
    N = cfg.num_patches + cfg.num_tokens
    for i in range(cfg.depth):
        hd = cfg.block_dims(i)[1]
        assert hd % 8 and A.attention_body(N, hd, BF16).name == "unaligned"
        assert A.attention_body(N, hd, F32).name == "general"
    model = ViT(cfg, generator=torch.Generator().manual_seed(0))
    # copies: to_jax's arrays may share memory with the parameters, which
    # the port's step updates in place
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)),
                                     to_jax(model))
    opt = dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=0.05,
               layer_decay=0.75, clip_grad=None)
    rng = np.random.default_rng(21)
    images = rng.uniform(0, 1, (2, 1, 4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (2, 1, 4))

    jtx = JL.build_finetune_optimizer(
        jparams, lr_schedule=lambda c: jnp.asarray(1e-3, jnp.float32),
        num_layers=cfg.depth, **opt)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jparams,
                           alphas=None, arch=None,
                           opt_state=jtx.init(jparams), ema_params=None)
    jstep = JS.make_train_step(jcfg, jtx, num_classes=10, smoothing=0.1,
                               compute_dtype=jnp.float32, donate=False)
    tx = LD.build_finetune_optimizer(model, lr_schedule=lambda c: 1e-3,
                                     num_layers=cfg.depth, **opt)
    state = S.TrainState(0, model, None, None,
                         tx.init(dict(model.named_parameters())))
    step = S.make_train_step(cfg, tx, num_classes=10, smoothing=0.1,
                             compute_dtype=torch.float32, device="cpu")
    for k in range(2):
        jstate, jm = jstep(jstate, images[k], labels[k],
                           jax.random.PRNGKey(k))
        state, m = step(state, torch.from_numpy(images[k]),
                        torch.from_numpy(labels[k]))
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = flatten_from_jax(np_tree(jstate.params))
    for n, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=2e-5, err_msg=n)

    x = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (8,))
    jev = JS.make_eval_step_dense(jcfg, compute_dtype=jnp.float32)(
        jstate.params, x, y)
    ev = S.make_eval_step_dense(cfg, compute_dtype=torch.float32,
                                device="cpu")(state.params,
                                              torch.from_numpy(x),
                                              torch.from_numpy(y))
    assert ev["loss_sum"].item() == pytest.approx(float(jev["loss_sum"]),
                                                  rel=1e-4)
    for k in ("top1", "top5", "count"):
        assert ev[k].item() == float(jev[k]), k
