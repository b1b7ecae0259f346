"""The layer-norm kernel pair's wrappers (ofb_tpu_torch/ops/layer_norm.py)
on the CPU, and the kernels on a card where there is one:

* `fused_layer_norm` on CPU tensors (its autograd Function over the plain
  versions of the kernels, the backward in closed form) equals the eager
  chain it replaces (`masked_layer_norm_reference`, `layer_norm_reference`)
  in its output and its gradients of x, gamma and beta: both passthrough
  modes and no mask, masks with dead channels and with none live, D 96,
  192, 276 and 384, row counts that are no multiple of any tile, fp32 and
  bf16; the mask gets no gradient;
* `ops.gates.masked_layer_norm` / `layer_norm` on the CPU are the eager
  twins, bit for bit, and move no launch counter;
* the vector width and the lane tier the wrappers pick from D, the type,
  the strides and the pointers; the C entries the wrappers bind; no atomics
  in the source; kernel names no trace reader takes for another class;
* (`card`, skipped without one) the kernels against the plain versions at
  ragged shapes, the graph-replay launch counts, and bit-equal repeats.

The card tests, on a card (this file imports no JAX):
`python3 -m pytest --noconftest -m card tests/test_torch_port_layer_norm.py`
"""

import re

import numpy as np
import pytest
import torch

from ofb_tpu_torch.ops import cuda_build
from ofb_tpu_torch.ops import gates as G
from ofb_tpu_torch.ops import layer_norm as L

torch.set_num_threads(1)
EPS = 1e-6
ROWS = (2, 3, 37)               # (batch, tokens, ...) leading dims: 222 rows


def _inputs(D, dtype, seed=0, lead=ROWS):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(lead + (D,)) * 2 + 0.5).to(dtype)
    scale = torch.from_numpy(1 + 0.3 * rng.standard_normal(D)).float()
    bias = torch.from_numpy(0.2 * rng.standard_normal(D)).float()
    dy = torch.from_numpy(rng.standard_normal(lead + (D,))).to(dtype)
    return x, scale, bias, dy


def _mask(D, kind, seed=1):
    if kind == "none":
        return None
    if kind == "dead":
        return torch.zeros(D)
    m = (np.random.default_rng(seed).random(D) > 0.35).astype(np.float32)
    return torch.from_numpy(m)


def _grads(fn, x, scale, bias, dy):
    x, scale, bias = (t.detach().clone().requires_grad_() for t in
                      (x, scale, bias))
    y = fn(x, scale, bias)
    y.backward(dy)
    return y.detach(), x.grad, scale.grad, bias.grad


def _eager(mask, passthrough):
    if mask is None:
        return lambda x, s, b: L.layer_norm_reference(x, s, b, eps=EPS)
    return lambda x, s, b: L.masked_layer_norm_reference(
        x, mask, s, b, eps=EPS, passthrough=passthrough)


def _fused(mask, passthrough):
    return lambda x, s, b: L.fused_layer_norm(x, s, b, mask=mask, eps=EPS,
                                              passthrough=passthrough)


def _close(got, want, dtype, what):
    got, want = got.float(), want.float()
    if dtype == torch.bfloat16:
        # a rounding to bf16 of fp32 values that differ in their last bits
        # can land one bf16 step (2^-8 relative) apart
        tol = 2.0 ** -7 * want.abs() + 1e-6
    else:
        tol = 1e-5 * want.abs().max() + 1e-6
    bad = (got - want).abs() > tol
    assert not bad.any(), (what, (got - want).abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [96, 192, 276, 384])
@pytest.mark.parametrize("kind", ["none", "zero", "identity"])
def test_fused_equals_the_eager_chain(kind, D, dtype):
    passthrough = None if kind == "none" else kind
    mask = _mask(D, "none" if kind == "none" else "some", seed=D)
    x, scale, bias, dy = _inputs(D, dtype, seed=D)
    want = _grads(_eager(mask, passthrough), x, scale, bias, dy)
    got = _grads(_fused(mask, passthrough), x, scale, bias, dy)
    for what, g, w in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        _close(g, w, dtype if what in ("y", "dx") else torch.float32, what)
    if mask is not None:
        dead = mask == 0
        assert dead.any()
        assert torch.equal(got[2][dead], torch.zeros_like(got[2][dead]))
        assert torch.equal(got[3][dead], torch.zeros_like(got[3][dead]))
        if kind == "identity":                   # passed through exactly
            assert torch.equal(got[0][..., dead], x[..., dead])
            assert torch.equal(got[1][..., dead], dy[..., dead])
        else:
            assert not got[0][..., dead].any() and not got[1][..., dead].any()


@pytest.mark.parametrize("passthrough", ["zero", "identity"])
def test_a_mask_with_no_live_channel(passthrough):
    D = 192
    mask = _mask(D, "dead")
    x, scale, bias, dy = _inputs(D, torch.float32, lead=(5, 7))
    want = _grads(_eager(mask, passthrough), x, scale, bias, dy)
    got = _grads(_fused(mask, passthrough), x, scale, bias, dy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not got[2].any() and not got[3].any()


def test_the_mask_gets_no_gradient_and_the_row_moments():
    D = 96
    x, scale, bias, _ = _inputs(D, torch.float32, lead=(4, 9))
    mask = _mask(D, "some").requires_grad_()
    y = L.fused_layer_norm(x, scale, bias, mask=mask, passthrough="zero")
    y.sum().backward()
    assert mask.grad is None
    live = mask.detach() > 0
    _, mean, rstd = L.layer_norm_fwd(x.reshape(-1, D), mask.detach(), scale,
                                     bias, EPS, "zero")
    xl = x.reshape(-1, D)[:, live].double()
    assert torch.allclose(mean.double(), xl.mean(-1), atol=1e-6)
    assert torch.allclose(rstd.double(), 1 / torch.sqrt(
        xl.var(-1, unbiased=False) + EPS), rtol=1e-5)


@pytest.mark.parametrize("kind", ["none", "zero", "identity"])
def test_gates_run_the_eager_twin_on_the_cpu(kind):
    D = 276
    x, scale, bias, _ = _inputs(D, torch.bfloat16, lead=(3, 11))
    L.reset_launch_counts()
    if kind == "none":
        got = G.layer_norm(x, scale, bias, eps=EPS)
        want = L.layer_norm_reference(x, scale, bias, eps=EPS)
    else:
        mask = _mask(D, "some")
        got = G.masked_layer_norm(x, mask, scale, bias, eps=EPS,
                                  passthrough=kind)
        want = L.masked_layer_norm_reference(x, mask, scale, bias, eps=EPS,
                                             passthrough=kind)
    assert torch.equal(got, want)
    L.fused_layer_norm(x.float(), scale, bias).sum()
    assert all(n == 0 for n in L.launch_counts().values())
    assert L.layer_norm_fwd.launches == L.layer_norm_bwd.launches == 0


def test_bad_passthrough_raises():
    x, scale, bias, _ = _inputs(8, torch.float32, lead=(2,))
    with pytest.raises(ValueError, match="middle"):
        L.fused_layer_norm(x, scale, bias, mask=torch.ones(8),
                           passthrough="middle")
    with pytest.raises(ValueError, match="middle"):
        G.masked_layer_norm(x, torch.ones(8), scale, bias,
                            passthrough="middle")


@pytest.mark.parametrize("D,itemsize,rows,want", [
    (384, 2, [(0, 384)], (16, 8, 3)),    # the search's rows, bf16
    (192, 2, [(0, 192)], (8, 8, 3)),     # the finetune's
    (384, 4, [(0, 384)], (16, 4, 6)),    # fp32
    (192, 4, [(0, 192)], (8, 4, 6)),
    (276, 2, [(0, 276)], (32, 4, 3)),    # an exported subnet's width
    (96, 2, [(0, 96)], (8, 8, 2)),       # Swin-T's first stage
    (768, 2, [(0, 768)], (32, 8, 3)),
    (1024, 2, [(0, 1024)], (32, 8, 4)),
    (1280, 2, [(0, 1280)], (32, 8, 0)),  # ViT-H: the looped kernels
    (384, 2, [(2, 384)], (32, 1, 0)),    # a view one element in
    (384, 2, [(0, 385)], (32, 1, 0)),    # rows of an odd stride
    (384, 2, [(0, 384), (8, 384)], (32, 4, 3)),   # dy on 8 bytes only
    (384, 2, [(0, 384), (4, 384)], (32, 2, 0)),   # dy on 4 bytes only
    (262, 2, [(0, 262)], (32, 2, 0)),    # bf16 rows not in pairs of pairs
    (7, 4, [(0, 7)], (32, 1, 0)),        # fp32 rows of an odd length
    (6, 4, [(0, 6)], (32, 2, 1)),       # fp32 chunks of 8 bytes: 32 lanes
    (8, 2, [(0, 8)], (8, 8, 1)),
    (1280, 4, [(0, 1280)], (32, 4, 0)),
])
def test_row_layout(D, itemsize, rows, want):
    assert L.row_layout(D, itemsize, *rows) == want
    lanes, vec, nv = want
    assert vec == L.vector_width(D, itemsize, *rows)
    if nv:                     # a row fits a group's lanes, none of them idle
        assert lanes * vec * nv >= D and vec * nv <= L._MAX_LANE
        assert lanes * vec * (nv - 1) < D or nv == 1
        assert vec * itemsize >= 8 and (lanes == 32 or vec * itemsize == 16)


def test_the_c_entries_and_kernel_names():
    src = (cuda_build.CSRC / cuda_build.SOURCES["layer_norm"]).read_text()
    for entry in ("ofb_layer_norm_grid", "ofb_layer_norm_fwd",
                  "ofb_layer_norm_bwd"):
        assert f'extern "C" int {entry}(' in src
    assert not re.search(r"atomic\w*\s*\(", src, re.IGNORECASE)
    kernels = re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", src)
    assert set(kernels) >= {"layer_norm_fwd_rows", "layer_norm_bwd_rows",
                            "layer_norm_sum_partials", "layer_norm_fwd_loop",
                            "layer_norm_bwd_loop", "layer_norm_bwd_cols"}
    other = ("attention_", "nccl", "gemm", "nvjet", "xmma", "cutlass",
             "cublas", "memcpy", "memset")
    for name in kernels + ["ofb_ln"]:
        assert not any(o in name.lower() for o in other), name
    # every (lanes, vec, tier) the wrappers can pick has an instance
    for bf16, vecs in ((1, (8, 4)), (0, (4, 2))):
        ty = "__nv_bfloat16" if bf16 else "float"
        for vec in vecs:
            for lanes in (L._GROUPS if vec * (2 if bf16 else 4) == 16
                          else (32,)):
                for nv in L._TIERS:
                    if vec * nv > L._MAX_LANE:
                        continue
                    args = f"({ty}, {bf16}, {lanes}, {vec})"
                    listed = (f"OFB_LN_WIDE{args}" in src or (
                        nv <= 4 and f"OFB_LN_TIERS{args}" in src))
                    assert listed, (ty, lanes, vec, nv)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,lead,kind", [
    (384, (4, 197), "identity"), (384, (3, 197), "zero"),
    (192, (5, 197), "none"), (96, (7, 49), "identity"),
    (276, (3, 197), "zero"), (1280, (2, 257), "none"),
    (1280, (2, 257), "identity"), (8, (33,), "dead")])
def test_kernels_against_the_plain_versions(card, D, lead, kind, dtype):
    passthrough = {"none": None, "dead": "zero"}.get(kind, kind)
    mask = _mask(D, "dead" if kind == "dead" else "some", seed=D) \
        if kind != "none" else None
    x, scale, bias, dy = _inputs(D, dtype, seed=D, lead=lead)
    x2, dy2 = x.reshape(-1, D), dy.reshape(-1, D)
    want_f = L.layer_norm_fwd_reference(x2, mask, scale, bias, EPS,
                                        passthrough)
    want_b = L.layer_norm_bwd_reference(x2, dy2, mask, scale, want_f[1],
                                        want_f[2], passthrough)
    on = [None if t is None else t.to(card)
          for t in (x2, dy2, mask, scale, bias)]
    got_f = L.layer_norm_fwd(on[0], on[2], on[3], on[4], EPS, passthrough)
    got_b = L.layer_norm_bwd(on[0], on[1], on[2], on[3], got_f[1], got_f[2],
                             passthrough)
    again = L.layer_norm_bwd(on[0], on[1], on[2], on[3], got_f[1], got_f[2],
                             passthrough)
    torch.cuda.synchronize(card)
    for g, w, what in zip(got_f + got_b, want_f + want_b,
                          ("y", "mean", "rstd", "dx", "dgamma", "dbeta")):
        _close(g.cpu(), w, dtype if what in ("y", "dx") else torch.float32,
               what)
    for a, b in zip(got_b, again):
        assert torch.equal(a, b)
