"""Swin's window-attention kernel pair's wrappers
(ofb_tpu_torch/ops/window_attention.py) on the CPU, and the kernels on a
card where there is one:

* `window_attention` on CPU tensors (its autograd Function over the plain
  versions of the kernels: a forward that returns the output and the row
  log-sum-exp, a backward recomputed from them) equals autograd of the
  eager chain of `models.swin.window_softmax_attend` in fp32, at Swin-T's
  four stage shapes (heads 3, 6, 12, 24 at 56, 28, 14 and 7 tokens a side)
  cut to a few windows, with and without the shift mask, at head dim 32
  and at a trimmed 20: the output and the gradients of qkv and of the
  relative-bias table; a scale handed in as a tensor gives the same;
* `window_softmax_attend` on the CPU is the eager chain, bit for bit
  (against a copy of it here), forward and gradients, and moves no launch
  counter;
* the shapes the kernels take and the message of those they do not, the
  copy width from the row and its pointers; the C entries the wrappers
  bind, no atomics in the source, kernel names no trace reader takes for
  another class;
* (`card`, skipped without one) the kernels against the plain versions in
  bf16 and fp32 at the four stage shapes and a trimmed head dim, the bias
  gradient bit-identical across two runs, a shape outside the kernels'
  coverage raising before any launch, the launches a replay of the
  captured Swin search step makes (12 forward and 12 backward a
  microbatch), and no score tensor made on the card.

The card tests, on a card (this file imports no JAX):
`python3 -m pytest --noconftest -m card tests/test_torch_port_window_attention.py`
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from ofb_tpu_torch.models import swin as S
from ofb_tpu_torch.ops import cuda_build
from ofb_tpu_torch.ops import window_attention as W

torch.set_num_threads(1)
WINDOW = 7
N = WINDOW * WINDOW
# Swin-T's stages: (tokens a side, heads)
STAGES = ((56, 3), (28, 6), (14, 12), (7, 24))


def _stage(res, heads, d, masked, dtype, windows=4, images=1, seed=0):
    """(qkv, rel_bias, rel_idx, mask, dout) of a stage: every window of
    `images` images with the shift mask (nW of them an image), else
    `windows` windows."""
    rng = np.random.default_rng(seed)
    nW = (res // WINDOW) ** 2
    mask = None
    if masked:
        mask = torch.from_numpy(S.shifted_window_mask(res, WINDOW,
                                                      WINDOW // 2))
    Bw = nW * images if masked else windows
    qkv = torch.from_numpy(rng.standard_normal((Bw, N, 3 * heads * d))
                           ).to(dtype)
    rel_bias = torch.from_numpy(0.5 * rng.standard_normal(
        ((2 * WINDOW - 1) ** 2, heads))).float()
    dout = torch.from_numpy(rng.standard_normal((Bw, N, heads * d))
                            ).to(dtype)
    return qkv, rel_bias, S._rel_index(WINDOW, torch.device("cpu")), mask, \
        dout


def _grads(fn, qkv, rel_bias, dout):
    qkv, rel_bias = (t.detach().clone().requires_grad_()
                     for t in (qkv, rel_bias))
    out = fn(qkv, rel_bias)
    gq, gb = torch.autograd.grad(out, (qkv, rel_bias), dout)
    return out.detach(), gq, gb


def _eager_chain(qkv, heads, scale, rel_bias, rel_idx, mask):
    """The eager chain `window_softmax_attend` ran before its kernels, frozen
    here."""
    Bw, N_, _ = qkv.shape
    hd = qkv.shape[-1] // (3 * heads)
    q, k, v = qkv.reshape(Bw, N_, 3, heads, hd).permute(2, 0, 3, 1, 4)
    attn = torch.matmul(q, k.transpose(-2, -1)).float() * scale
    bias = rel_bias.float()[rel_idx].reshape(N_, N_, heads).permute(2, 0, 1)
    attn = attn + bias
    if mask is not None:
        nW = mask.shape[0]
        attn = (attn.reshape(Bw // nW, nW, heads, N_, N_)
                + mask[None, :, None]).reshape(Bw, heads, N_, N_)
    attn = torch.softmax(attn, dim=-1).to(qkv.dtype)
    return torch.matmul(attn, v).transpose(1, 2).reshape(Bw, N_, heads * hd)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("d", [32, 20])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("res,heads", STAGES)
def test_the_function_equals_autograd_of_the_eager_chain(res, heads, masked,
                                                         d):
    qkv, rel_bias, idx, mask, dout = _stage(res, heads, d, masked,
                                            torch.float32, seed=res + d)
    scale = d ** -0.5
    want = _grads(lambda q, b: S.window_softmax_attend(q, heads, scale, b,
                                                       idx, mask),
                  qkv, rel_bias, dout)
    got = _grads(lambda q, b: W.window_attention(q, heads, scale, b, idx,
                                                 mask),
                 qkv, rel_bias, dout)
    for g, w, what in zip(got, want, ("out", "dqkv", "drel_bias")):
        assert g.shape == w.shape and g.dtype == w.dtype, what
        # fp32 sums in another order (the backward from the log-sum-exp
        # and delta = rowsum(dout out) in closed form)
        assert _rel(g, w) < 1e-5, (what, _rel(g, w))
    tensor_scale = _grads(lambda q, b: W.window_attention(
        q, heads, torch.tensor(scale), b, idx, mask), qkv, rel_bias, dout)
    for a, b in zip(tensor_scale, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [True, False])
def test_window_softmax_attend_on_the_cpu_is_the_eager_chain(masked, dtype):
    qkv, rel_bias, idx, mask, dout = _stage(28, 6, 32, masked, dtype,
                                            windows=3, seed=5)
    W.reset_launch_counts()
    before = W.launch_counts()
    want = _grads(lambda q, b: _eager_chain(q, 6, 32 ** -0.5, b, idx, mask),
                  qkv, rel_bias, dout)
    got = _grads(lambda q, b: S.window_softmax_attend(q, 6, 32 ** -0.5, b,
                                                      idx, mask),
                 qkv, rel_bias, dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert W.launch_counts() == before


def test_the_plain_versions_count_launches_on_the_cpu_wrappers():
    qkv, rel_bias, idx, mask, dout = _stage(14, 12, 20, True, torch.float32)
    W.reset_launch_counts()
    out, lse = W.window_attention_fwd(qkv, 12, 0.2, rel_bias, idx, mask)
    assert out.shape == (4, N, 12 * 20) and lse.shape == (4, 12, N)
    assert torch.allclose(lse, torch.logsumexp(W._logits(
        *W._split(qkv, 12)[:2], 0.2, rel_bias, idx, mask), dim=-1))
    dqkv, dtable = W.window_attention_bwd(qkv, out, dout, lse, 12, 0.2,
                                          rel_bias, idx, mask)
    assert dqkv.shape == qkv.shape and dtable.shape == rel_bias.shape
    # the CPU wrappers run the plain versions and count nothing
    assert not any(W.launch_counts().values())


@pytest.mark.parametrize("shape,heads,dtype,nW,match", [
    ((4, 65, 3 * 2 * 32), 2, torch.bfloat16, 1, r"\(4, 65, 192\).*65 tokens"),
    ((4, 49, 3 * 2 * 72), 2, torch.bfloat16, 1, r"head dim 72"),
    ((4, 49, 3 * 2 * 32 + 1), 2, torch.float32, 1, r"\(4, 49, 193\)"),
    ((6, 49, 3 * 2 * 32), 2, torch.bfloat16, 4, r"6 windows.*4"),
    ((4, 0, 3 * 2 * 32), 2, torch.float32, 1, r"0 tokens"),
])
def test_shapes_outside_the_coverage_raise(shape, heads, dtype, nW, match):
    with pytest.raises(ValueError, match=match):
        W.check_shape(shape, heads, dtype, nW)


def test_the_coverage():
    for n in (1, 16, 49, 64):
        for d in (1, 7, 20, 32, 48, 64):
            assert W.check_shape((2, n, 3 * 4 * d), 4, torch.bfloat16) \
                == (n, d)
    with pytest.raises(TypeError, match="float16"):
        W.check_shape((2, 49, 96), 1, torch.float16)
    assert [W.padded_dim(d) for d in (1, 16, 17, 20, 32, 33, 48, 64)] \
        == [16, 16, 32, 32, 32, 48, 48, 64]


@pytest.mark.parametrize("d,itemsize,ptrs,want", [
    (32, 2, (0, 4096), 16), (20, 2, (0,), 8), (20, 2, (8,), 8),
    (20, 2, (4,), 4), (7, 2, (0,), 2), (32, 2, (2,), 2), (6, 2, (0,), 4),
    (32, 4, (0,), 16), (5, 4, (0,), 4), (6, 4, (8,), 8)])
def test_copy_width(d, itemsize, ptrs, want):
    assert W.copy_width(d, itemsize, *ptrs) == want


def test_the_c_entries_and_kernel_names():
    src = (cuda_build.CSRC / cuda_build.SOURCES["window_attention"]
           ).read_text()
    for entry in ("ofb_window_attn_grid", "ofb_window_attn_fwd",
                  "ofb_window_attn_bwd"):
        assert f'extern "C" int {entry}(' in src
    assert not re.search(r"atomic\w*\s*\(", src, re.IGNORECASE)
    kernels = re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", src)
    assert set(kernels) == {
        "window_attn_fwd", "window_attn_bwd", "window_attn_fwd_f32",
        "window_attn_bwd_f32", "window_attn_bias_sum",
        "window_attn_bias_table"}
    other = ("attention_", "nccl", "gemm", "nvjet", "xmma", "cutlass",
             "cublas", "memcpy", "memset", "ofb_span", "ofb_mark")
    for name in kernels + ["ofb_win"]:
        assert not any(o in name.lower() for o in other), name
    # every bf16 depth the wrapper can pick has an instance
    for d in range(1, W.MAX_HEAD_DIM + 1):
        assert f"window_attn_fwd<{W.padded_dim(d)}>" in src
        assert f"window_attn_bwd<{W.padded_dim(d)}>" in src


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

# largest error against the plain version, as a share of its largest
# magnitude: bf16 outputs round once more or less than the plain version's
# (a bf16 step is 2^-8 relative); the fp32 body sums in another order
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
TOL_TABLE = {torch.bfloat16: 1e-3, torch.float32: 1e-5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


def _on(card, *ts):
    return [None if t is None else t.to(card) for t in ts]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("res,heads,d,masked", [
    (56, 3, 32, True), (28, 6, 32, True), (14, 12, 32, True),
    (7, 24, 32, False), (28, 6, 20, True), (7, 24, 20, False)])
def test_kernels_against_the_plain_versions(card, res, heads, d, masked,
                                            dtype):
    qkv, rel_bias, idx, mask, dout = _on(card, *_stage(
        res, heads, d, masked, dtype, windows=8, images=2, seed=res))
    scale = d ** -0.5
    want_f = W.window_attention_fwd_reference(qkv, heads, scale, rel_bias,
                                              idx, mask)
    want_b = W.window_attention_bwd_reference(qkv, want_f[0], dout,
                                              want_f[1], heads, scale,
                                              rel_bias, idx, mask)
    W.reset_launch_counts()
    got_f = W.window_attention_fwd(qkv, heads, scale, rel_bias, idx, mask)
    got_b = W.window_attention_bwd(qkv, got_f[0], dout, got_f[1], heads,
                                   scale, rel_bias, idx, mask)
    torch.cuda.synchronize(card)
    kind = "bf16" if dtype == torch.bfloat16 else "fp32"
    assert W.window_attention_fwd.by_kind[kind] == 1
    assert W.window_attention_bwd.by_kind[kind] == 1
    for g, w, tol, what in zip(got_f + got_b, want_f + want_b,
                               (TOL[dtype], 1e-5, TOL[dtype],
                                TOL_TABLE[dtype]),
                               ("out", "lse", "dqkv", "dtable")):
        assert g.shape == w.shape and g.dtype == w.dtype, what
        assert torch.isfinite(g).all(), what
        assert _rel(g, w) < tol, (what, _rel(g, w))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_bias_gradient_is_bit_identical_across_runs(card, dtype):
    qkv, rel_bias, idx, mask, dout = _on(card, *_stage(
        56, 3, 32, True, dtype, images=4, seed=3))
    out, lse = W.window_attention_fwd(qkv, 3, 32 ** -0.5, rel_bias, idx,
                                      mask)
    runs = [W.window_attention_bwd(qkv, out, dout, lse, 3, 32 ** -0.5,
                                   rel_bias, idx, mask) for _ in range(2)]
    torch.cuda.synchronize(card)
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0], runs[1][0])


@pytest.mark.card
@pytest.mark.parametrize("shape,heads,dtype", [
    ((4, 65, 96), 1, torch.bfloat16), ((4, 49, 3 * 72), 1, torch.bfloat16),
    ((4, 49, 96), 1, torch.float16)])
def test_a_shape_outside_the_coverage_raises_on_the_card(card, shape, heads,
                                                         dtype):
    qkv = torch.zeros(shape, dtype=dtype, device=card)
    rel_bias = torch.zeros(169, heads, device=card)
    idx = S._rel_index(WINDOW, card)
    W.reset_launch_counts()
    with pytest.raises((ValueError, TypeError), match=r"float16|tokens"):
        W.window_attention(qkv, heads, 0.2, rel_bias, idx)
    assert not any(W.launch_counts().values())


@pytest.mark.card
def test_a_replay_of_the_captured_swin_search_step(card):
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.core.swin_steps import make_planned_swin_search_step
    mb, accum = 8, 2
    bundle, state, _, _, _ = B.build_swin_step("swin_tiny", mb, seed=8)
    scfg, tx = B.search_config(mb)
    scfg = dataclasses.replace(scfg, accum_iter=accum)
    pstep, _ = make_planned_swin_search_step(
        bundle.space, bundle.cfg, scfg, tx, phase="search",
        steps_per_epoch=9, device="cuda")
    calls = B.PlannedCalls(pstep, {"state": state}, mb * accum, 9,
                           search=True, images=32, seed=9)
    W.reset_launch_counts()
    for _ in range(pstep.WARMUP + 2):             # eager, capture, replay
        calls.graph()
    torch.cuda.synchronize(card)
    blocks = sum(bundle.cfg.depths)
    per = {k: n for k, n in pstep.launches_per_replay.items()
           if k[0].startswith("window_attention")}
    assert pstep.captures == 1
    assert per == {("window_attention_fwd", "bf16"): blocks * accum,
                   ("window_attention_bwd", "bf16"): blocks * accum,
                   ("window_attention_fwd", "fp32"): 0,
                   ("window_attention_bwd", "fp32"): 0}
    # the eager calls and the replays, every call through the kernels
    assert W.window_attention_fwd.by_kind == {
        "bf16": (pstep.WARMUP + 2) * blocks * accum, "fp32": 0}


@pytest.mark.card
def test_no_score_tensor_is_made_on_the_card(card):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Outputs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.shapes.append((str(func), tuple(t.shape)))
            return out

    heads, d = 6, 8
    qkv, rel_bias, idx, mask, dout = _on(card, *_stage(
        28, heads, d, True, torch.bfloat16, images=64, seed=4))
    Bw = qkv.shape[0]
    qkv.requires_grad_()
    rel_bias.requires_grad_()
    with Outputs() as seen:
        out = S.window_softmax_attend(qkv, heads, d ** -0.5, rel_bias, idx,
                                      mask)
        _, lse = W.window_attention_fwd(qkv.detach(), heads, d ** -0.5,
                                        rel_bias.detach(), idx, mask)
        W.window_attention_bwd(qkv.detach(), out.detach(), dout, lse, heads,
                               d ** -0.5, rel_bias.detach(), idx, mask)
    scores = [(f, s) for f, s in seen.shapes
              if s[-2:] == (N, N) and int(np.prod(s)) >= Bw * N * N]
    assert not scores, scores
    # and the whole autograd pair holds less than one fp32 score tensor
    torch.cuda.synchronize(card)
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    out = S.window_softmax_attend(qkv, heads, d ** -0.5, rel_bias, idx, mask)
    torch.autograd.grad(out, (qkv, rel_bias), dout)
    torch.cuda.synchronize(card)
    peak = torch.cuda.max_memory_allocated(card) - base
    assert peak < Bw * heads * N * N * 4, peak
