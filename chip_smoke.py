#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ofb_tpu_torch) on one GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each of
which raises (and so exits non-zero) on failure:

  1. card: name and power limit, CUDA version, and the build of every
     kernel from ofb_tpu_torch/csrc (one nvcc per source, in parallel);
  2. kernels: each kernel's wrapper against its plain PyTorch twin on the
     same inputs, both bodies (the resident `wgmma` one and the general
     one, each asked for by name), at the DeiT-S shapes of the search step,
     the exported subnet's shapes (head dims 8 * odd among them, which the
     resident body runs zero-padded to the next multiple of 16) and ragged
     shapes, in bf16 and fp32 (TF32 off), every output finite;
  3. timing: both bodies of each kernel with CUDA events at batch 256, in
     turns (general, resident, resident, general), beside the bound, the
     plain twin and torch's scaled_dot_product_attention (timed here as a
     yardstick only; the port never calls it); the resident body also at
     batch 64; then at each attention shape of the exported subnet, batch
     256: resident, general (asked for by name), twin and SDPA. Each of
     these also as device time (torch.profiler: the kernels' summed
     durations, the host's dispatch left out);
  4. reference: the port's DeiT-S forward and backward on the card (fp32,
     kernels) against the same model on the CPU (fp32, plain twins); the
     card's pass is a driven path of its own, counted from 0: 12 + 12
     launches, all through the general body (fp32);
  5. the slice: the DeiT-S search step at full width on the card, bf16,
     batch 64: finite losses, and the attention kernels launched exactly
     12 + 12 times per microbatch, counted from 0, all through the
     resident body;
  6. the lifecycle, DeiT-S at full width and depth, batch 64: two search
     steps; crafted alphas and one `compress` pass that converges every
     module to a subnet of mixed head geometry (moments of the touched
     leaves zeroed, no tensor re-allocated); two postsearch steps (Mixup
     on; decoder and mask token bit-identical); `fuse_params`, with gated
     == fused == sliced logits in fp32 through the CUDA kernels;
     `export_subnet`; dense train steps (layer-decay AdamW, Mixup, EMA)
     and eval steps on the subnet in bf16, their attention launches
     counted from 0 and held, body by body, to what `attention_body`
     predicts for each block's (N, d): all 12 blocks, head dims 24, 40 and
     56 among them, through the resident body, none through the general.

The line before the last is the kernels' JSON (`launches` sums the three
driven paths, `launches_fp32`, `launches_search` and `launches_lifecycle`
give each); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_FLOPS = 989e12              # H100 SXM, dense
# Tolerances, as max |kernel - twin| / max |twin|, the twin in fp32 on the
# same inputs. fp32: summation order only. bf16: the outputs are rounded
# to bf16 (relative step 2^-8) and so are p before p @ v and ds before the
# dq / dk products, each a relative error up to 2^-9 per term.
TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}
DEIT_S = (64, 197, 6, 64)        # B, N, H, d of the search step at batch 64
# the attention shapes of the lifecycle's exported subnet (phase 6); all
# take the resident body in bf16, 40, 24 and 56 zero-padded to 48, 32, 64
SUBNET = [(64, 197, 6, 32), (64, 197, 4, 48), (64, 197, 6, 16),
          (64, 197, 4, 40), (64, 197, 2, 24), (64, 197, 6, 56)]
# ragged shapes, head dims 8 * odd among them: 8 -> 16, 24 -> 32 and 40 ->
# 48 in 64-column tiles (one fused backward kernel), 72 -> 80 and 120 ->
# 128 in 128-column tiles (a dq and a dk/dv kernel)
RAGGED = [(3, 17, 2, 16), (3, 17, 2, 8), (2, 33, 3, 24), (2, 70, 2, 40),
          (2, 197, 2, 72), (2, 256, 2, 120)]
# the resident body: bf16, N <= 256, d a multiple of 8, aligned rows
RESIDENT = [DEIT_S, (2, 197, 6, 32), (2, 197, 3, 128), (2, 50, 4, 32),
            (2, 256, 2, 64)] + RAGGED + SUBNET
# the general body: more than 256 tokens, unaligned views and fp32; asked
# for by name at the resident body's shapes too
GENERAL = [DEIT_S, (2, 257, 2, 64)] + RAGGED + SUBNET
TIMING = (256, 197, 6, 64)
# fp32 logits of two forms of one model on the card, as max |a - b| over
# max |b|: 12 blocks of fp32 sums in other orders (TF32 off)
TOL_LOGITS = 1e-4
ATTN_SRC = "ofb_tpu/ops/pallas_attention.py"


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters=20, warmup=3):
    """Device time of one call of `fn`: the summed durations of the kernels
    it launched over `iters` calls, from torch.profiler, divided by
    `iters`. Unlike `cuda_time_ms` it leaves out the host's dispatch, which
    at small shapes takes longer than the kernel and so sets the pace of
    back-to-back calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler saw no device time")
    return us / iters / 1e3


def ptxas_report(log_text):
    """One line a kernel from nvcc's `-Xptxas -v` output: its name with its
    template arguments, registers a thread and spilled bytes."""
    import re
    name = None
    spills = ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d+(attention_\w+?_kernel)(I(?:Li\d+E|[a-z0-9_]+)*E)?",
                          m.group(1))
            name = m.group(1)[:60] if not k else k.group(1) + "<" + ", ".join(
                re.findall(r"Li(\d+)E", k.group(2) or "")) + ">"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"spills {m.group(1)} B stored, {m.group(2)} B loaded"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            yield f"{name}: {m.group(1)} registers, {spills}"
            name = None


def make_qkv(B, N, H, d, dtype, gen):
    """q pre-scaled and contiguous, k and v strided views of a
    (B, N, 3, H, d) buffer: what the search step hands the kernels."""
    import torch
    buf = torch.randn((B, N, 3, H, d), generator=gen, device="cuda").to(dtype)
    q = (buf[:, :, 0].float() * d ** -0.5).to(dtype)
    return q, buf[:, :, 1], buf[:, :, 2]


def rel_err(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def check_kernels(A):
    """Phase 2. Returns the max abs errors of both bodies at the search
    step's shape and type (DeiT-S, bf16)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(shape, torch.bfloat16, "resident") for shape in RESIDENT]
    cases += [(shape, dtype, "general") for shape in GENERAL
              for dtype in (torch.bfloat16, torch.float32)]
    main_err = {}
    for shape, dtype, body in cases:
        q, k, v = make_qkv(*shape, dtype, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        if A.attention_body(shape[1], shape[3], dtype).name != body \
                and body == "resident":
            raise AssertionError(f"{shape} {dtype} is not the resident body's")
        o, lse = A.attention_fwd(q, k, v, body=body)
        torch.cuda.synchronize()
        ro, rl = A.attention_fwd_reference(q.float(), k.float(), v.float())
        dq, dk, dv = A.attention_bwd(q, k, v, o, lse, do, body=body)
        torch.cuda.synchronize()
        ref = A.attention_bwd_reference(q.float(), k.float(), v.float(),
                                        do.float())
        tol = TOL[str(dtype).split(".")[-1]]
        if not all(t.isfinite().all() for t in (o, lse, dq, dk, dv)):
            raise AssertionError(f"the {body} body wrote values that are not "
                                 f"finite at {shape} {dtype}")
        fwd = rel_err(o, ro)
        lse_err = (lse - rl).abs().max().item()
        bwd = [rel_err(g, r) for g, r in zip((dq, dk, dv), ref)]
        log(f"kernels {body} {shape} {dtype}: fwd rel {fwd[1]:.3e}, lse "
            f"abs {lse_err:.3e}, bwd rel " +
            ", ".join(f"{e[1]:.3e}" for e in bwd) + f" (tol {tol:g})")
        if not (fwd[1] <= tol and lse_err <= 1e-3
                and max(e[1] for e in bwd) <= tol):
            raise AssertionError(f"the {body} body disagrees with its twin "
                                 f"at {shape} {dtype}")
        if shape == DEIT_S and dtype == torch.bfloat16:
            tag = "" if body == "resident" else "_general"
            main_err["attention_fwd" + tag] = fwd[0]
            main_err["attention_bwd" + tag] = max(e[0] for e in bwd)
    return main_err


def time_kernels(A):
    """Phase 3: ms of both bodies of each kernel, the twin and SDPA at
    batch 256, bf16, on this one card; the bodies in turns (general,
    resident, resident, general), each figure the mean of its two turns."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, N, H, d = TIMING
    q, k, v = make_qkv(B, N, H, d, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = A.attention_fwd(q, k, v)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    so = F.scaled_dot_product_attention(qg.transpose(1, 2), kg.transpose(1, 2),
                                        vg.transpose(1, 2), scale=1.0)
    sdo = do.transpose(1, 2)
    calls = {
        "attention_fwd": lambda body: A.attention_fwd(q, k, v, body=body),
        "attention_bwd": lambda body: A.attention_bwd(q, k, v, o, lse, do,
                                                      body=body)}
    plain = {
        "attention_fwd": lambda: A.attention_fwd_reference(q, k, v),
        "attention_bwd": lambda: A.attention_bwd_reference(q, k, v, do)}
    library = {
        "attention_fwd": lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=1.0),
        "attention_bwd": lambda: torch.autograd.grad(
            so, (qg, kg, vg), sdo, retain_graph=True)}
    elems = B * N * H * d
    bytes_ = {"attention_fwd": 4 * elems * 2, "attention_bwd": 7 * elems * 2}
    flops = {"attention_fwd": 4 * B * H * N * N * d,
             "attention_bwd": 10 * B * H * N * N * d}
    out = {}
    for name, call in calls.items():
        turns = [(body, cuda_time_ms(lambda: call(body))) for body in
                 ("general", "resident", "resident", "general")]
        ms = {body: sum(t for b, t in turns if b == body) / 2
              for body in ("general", "resident")}
        dev = {body: device_time_ms(lambda: call(body))
               for body in ("general", "resident")}
        t_bytes = bytes_[name] / HBM_BYTES_PER_S * 1e3
        t_ops = flops[name] / BF16_FLOPS * 1e3
        shared = dict(plain_ms=cuda_time_ms(plain[name]),
                      library_ms=cuda_time_ms(library[name]),
                      plain_device_ms=device_time_ms(plain[name]),
                      library_device_ms=device_time_ms(library[name]),
                      bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations")
        out[name] = dict(ms=ms["resident"], device_ms=dev["resident"],
                         **shared)
        out[name + "_general"] = dict(ms=ms["general"],
                                      device_ms=dev["general"], **shared)
        log(f"timing {name} B={B} bf16: turns " +
            ", ".join(f"{b} {t:.4f}" for b, t in turns) + f" ms; resident "
            f"{ms['resident']:.4f} ms is {ms['general'] / ms['resident']:.2f}x "
            f"faster than general {ms['general']:.4f} ms; plain "
            f"{shared['plain_ms']:.4f} ms, sdpa {shared['library_ms']:.4f} "
            f"ms, bound {shared['bound_ms']:.4f} ms ({shared['bound_by']}); "
            f"device time: resident {dev['resident']:.4f}, general "
            f"{dev['general']:.4f}, plain {shared['plain_device_ms']:.4f}, "
            f"sdpa {shared['library_device_ms']:.4f} ms")
        if ms["resident"] >= ms["general"]:
            raise AssertionError(f"{name}: the resident body is not faster "
                                 f"than the general one")
    # the search step's own batch in phase 5
    q, k, v = make_qkv(*DEIT_S, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = A.attention_fwd(q, k, v)
    t_f = cuda_time_ms(lambda: A.attention_fwd(q, k, v))
    t_b = cuda_time_ms(lambda: A.attention_bwd(q, k, v, o, lse, do))
    log(f"timing resident B={DEIT_S[0]} bf16: attention_fwd {t_f:.4f} ms, "
        f"attention_bwd {t_b:.4f} ms")
    return out


def time_subnet_shapes(A):
    """Phase 3, continued: each attention shape of the lifecycle's subnet,
    forward and backward, bf16, at batch 256 (the bench's): both bodies in
    turns (general asked for by name), the plain twin and SDPA, beside the
    bound, each also as device time; the serving body also at batch 64
    (phase 6's)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for _, N, H, d in SUBNET:
        body = A.attention_body(N, d, torch.bfloat16).name
        for B in (64, 256):
            q, k, v = make_qkv(B, N, H, d, torch.bfloat16, gen)
            do = torch.randn(q.shape, generator=gen,
                             device="cuda").to(torch.bfloat16)
            o, lse = A.attention_fwd(q, k, v)
            calls = {}
            for b in ("resident", "general"):
                calls["fwd_" + b] = lambda b=b: A.attention_fwd(q, k, v,
                                                                body=b)
                calls["bwd_" + b] = lambda b=b: A.attention_bwd(
                    q, k, v, o, lse, do, body=b)
            elems = B * N * H * d
            row = dict(shape=[B, N, H, d], body=body,
                       fwd_bound_ms=max(8 * elems / HBM_BYTES_PER_S,
                                        4 * B * H * N * N * d / BF16_FLOPS)
                       * 1e3,
                       bwd_bound_ms=max(14 * elems / HBM_BYTES_PER_S,
                                        10 * B * H * N * N * d / BF16_FLOPS)
                       * 1e3)
            if B == 64:
                row.update(fwd_ms=cuda_time_ms(calls["fwd_" + body], iters=10),
                           bwd_ms=cuda_time_ms(calls["bwd_" + body], iters=10))
                rows.append(row)
                log(f"timing subnet shape {(B, N, H, d)} bf16, {body} body: "
                    f"fwd {row['fwd_ms']:.4f} ms (bound "
                    f"{row['fwd_bound_ms']:.4f}), bwd {row['bwd_ms']:.4f} ms "
                    f"(bound {row['bwd_bound_ms']:.4f})")
                continue
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            qg, kg, vg = (t.detach().clone().requires_grad_()
                          for t in (qt, kt, vt))
            so = F.scaled_dot_product_attention(qg, kg, vg, scale=1.0)
            sdo = do.transpose(1, 2)
            calls.update(
                fwd_plain=lambda: A.attention_fwd_reference(q, k, v),
                bwd_plain=lambda: A.attention_bwd_reference(q, k, v, do),
                fwd_sdpa=lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, scale=1.0),
                bwd_sdpa=lambda: torch.autograd.grad(
                    so, (qg, kg, vg), sdo, retain_graph=True))
            for n in ("fwd", "bwd"):
                turns = [(b, cuda_time_ms(calls[f"{n}_{b}"], iters=10))
                         for b in ("general", "resident", "resident",
                                   "general")]
                for b in ("resident", "general"):
                    row[f"{n}_{b}_ms"] = sum(t for x, t in turns
                                             if x == b) / 2
                for b in ("plain", "sdpa"):
                    row[f"{n}_{b}_ms"] = cuda_time_ms(calls[f"{n}_{b}"],
                                                      iters=10)
                row[n + "_ms"] = row[f"{n}_{body}_ms"]
            for key, call in calls.items():
                row[key + "_device_ms"] = device_time_ms(call, iters=10)
            rows.append(row)
            log(f"timing subnet shape {(B, N, H, d)} bf16 ({body} body "
                f"serves it), ms (device ms): " + "; ".join(
                    f"{n} " + ", ".join(
                        f"{b} {row[f'{n}_{b}_ms']:.4f} "
                        f"({row[f'{n}_{b}_device_ms']:.4f})"
                        for b in ("resident", "general", "plain", "sdpa"))
                    + f", bound {row[n + '_bound_ms']:.4f}"
                    for n in ("fwd", "bwd")))
    return rows


def check_against_cpu(A):
    """Phase 4: the port's DeiT-S (full width, 12 blocks) forward and
    gradients on the card (fp32, CUDA kernels) against the same model on
    the CPU (fp32, plain twins), on 2 images with a fixed mask. Returns the
    launches of the card's pass, counted from 0: the fp32 path, which the
    general body serves."""
    import torch
    from ofb_tpu_torch.models.mim_vit import mim_forward
    from ofb_tpu_torch.models.registry import create_model

    res = {}
    g = torch.Generator().manual_seed(3)
    x = torch.rand((2, 224, 224, 3), generator=g)
    mask = (torch.rand((2, 196), generator=g) < 0.25).float()
    for dev in ("cpu", "cuda"):
        bundle = create_model("deit_small_patch16_224_mim", device=dev,
                              patch_search=True)
        params, alphas, arch = bundle.init(0)
        A.reset_launch_counts()
        out = mim_forward(params, alphas, arch, x.to(dev), bundle.cfg,
                          bundle.space, train=True, use_mim=True,
                          token_mask=mask.to(dev),
                          compute_dtype=torch.float32)
        (out.logits.square().mean() + out.decoder_loss).backward()
        grads = [p.grad.flatten() for p in
                 list(params.parameters()) + list(alphas.parameters())
                 if p.grad is not None]
        res[dev] = (out.logits.detach().cpu(), out.decoder_loss.item(),
                    torch.cat(grads).cpu())
    by_body = {"attention_fwd": dict(A.attention_fwd.by_body),
               "attention_bwd": dict(A.attention_bwd.by_body)}
    (lc, dc, gc), (lg, dg, gg) = res["cpu"], res["cuda"]
    # fp32 on both devices; 12 blocks of other summation orders
    e_logits = rel_err(lg, lc)[1]
    e_grads = rel_err(gg, gc)[1]
    log(f"reference DeiT-S fp32 card vs CPU: logits rel {e_logits:.3e}, "
        f"decoder loss {dg:.6f} vs {dc:.6f}, grads rel {e_grads:.3e}")
    if not (e_logits < 1e-3 and abs(dg - dc) <= 1e-4 * abs(dc)
            and e_grads < 1e-3 and math.isfinite(dg)):
        raise AssertionError("the port on the card disagrees with the CPU")
    took = {"resident": 0, "general": 12}
    if by_body != {"attention_fwd": took, "attention_bwd": took}:
        raise AssertionError(f"fp32 launches by body {by_body}, expected "
                             f"{took} each")
    log(f"reference: launches by body {by_body}")
    return {**{k: by["resident"] for k, by in by_body.items()},
            **{k + "_general": by["general"] for k, by in by_body.items()}}


def run_slice(A, steps=3):
    """Phase 5: the DeiT-S search step at batch 64 through the user entry
    points (create_model, build_search_optimizer, make_search_step, as
    ofb_tpu_torch.bench wires them); returns the launches counted over the
    run."""
    import torch
    from ofb_tpu_torch.bench import build_step

    batch = 64
    bundle, state, step, images, labels = build_step("deit_small", batch)
    if bundle.device.type != "cuda":
        raise AssertionError(f"the slice ran on {bundle.device}")
    gen = torch.Generator(device="cuda").manual_seed(4)

    A.reset_launch_counts()
    state, m = step(state, images, labels, gen, 0.75)      # first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, images, labels, gen, 0.75)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"attention_fwd": A.attention_fwd.launches,
                "attention_bwd": A.attention_bwd.launches}
    by_body = {"attention_fwd": dict(A.attention_fwd.by_body),
               "attention_bwd": dict(A.attention_bwd.by_body)}

    vals = {k: v.item() for k, v in m.items()}
    log("slice metrics: " + json.dumps(vals))
    for k in ("loss_total", "loss_param", "loss_arch", "loss_decoder"):
        if not math.isfinite(vals[k]):
            raise AssertionError(f"{k} is not finite")
    micro = steps + 1
    want = 12 * micro
    if launches != {"attention_fwd": want, "attention_bwd": want}:
        raise AssertionError(f"launches {launches}, expected {want} each "
                             f"(12 per microbatch, {micro} microbatches)")
    took = {"resident": want, "general": 0}
    if by_body != {"attention_fwd": took, "attention_bwd": took}:
        raise AssertionError(f"the slice did not run the resident body "
                             f"throughout: {by_body}")
    img_s = batch * steps / dt
    log(f"slice: DeiT-S search step, batch {batch}, bf16: {img_s:.2f} img/s "
        f"({dt / steps * 1e3:.2f} ms/step over {steps} steps); launches "
        f"{launches}, all through the resident body")
    return {**launches, "attention_fwd_general": by_body["attention_fwd"]
            ["general"], "attention_bwd_general": by_body["attention_bwd"]
            ["general"]}


def _finite(metrics, where):
    vals = {k: v.item() for k, v in metrics.items()}
    for k, v in vals.items():
        if not math.isfinite(v):
            raise AssertionError(f"{where}: {k} is not finite")
    return vals


def run_lifecycle(A, card, steps=3):
    """Phase 6: search -> compress -> postsearch -> fuse -> export ->
    subnet train and eval, DeiT-S at full width and depth, batch 64,
    through the user entry points as ofb_tpu_torch.bench wires them.
    `card` is nvidia-smi's name and power limit, printed beside the rates.
    Returns the launches counted over the whole phase."""
    import torch
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.core.optim import named_leaves
    from ofb_tpu_torch.core.steps import make_eval_step
    from ofb_tpu_torch.models.mim_vit import fuse_params, mim_forward
    from ofb_tpu_torch.models.vit import vit_forward

    batch = 64
    bundle, state, step, images, labels = B.build_step("deit_small", batch,
                                                       seed=5)
    cfg, space = bundle.cfg, bundle.space
    gen = torch.Generator(device="cuda").manual_seed(6)
    totals = {"attention_fwd": {"resident": 0, "general": 0},
              "attention_bwd": {"resident": 0, "general": 0}}

    def take_counts():
        """The launches since the last reset, by body; adds them to the
        phase's totals and sets the counts to 0."""
        got = {"attention_fwd": dict(A.attention_fwd.by_body),
               "attention_bwd": dict(A.attention_bwd.by_body)}
        for k, by in got.items():
            for body, n in by.items():
                totals[k][body] += n
        A.reset_launch_counts()
        return got

    # 6.1 two search steps, then a forced prune to convergence
    A.reset_launch_counts()
    for _ in range(2):
        state, m = step(state, images, labels, gen, 0.75)
    _finite(m, "lifecycle search step")
    leaves = named_leaves(state.params, state.alphas)
    objects = {n: id(p) for n, p in leaves.items()}
    moments = {n: id(t) for n, t in state.opt_state.mu.items()}
    report, ms, idle_ms = B.force_convergence(state, space)
    if not (report.finish_search and state.arch.all_finished):
        raise AssertionError(f"compress did not converge: {report.events}")
    touched = [n for n in leaves
               if n.startswith("alphas.") or n.endswith(".score")]
    if len(report.events) != 2 + 2 * cfg.depth or len(touched) != \
            2 * (2 + 2 * cfg.depth) - 1:
        raise AssertionError(f"compress events: {report.events}")
    dirty = [n for n in touched if state.opt_state.mu[n].any()
             or state.opt_state.nu[n].any()]
    if dirty or not state.opt_state.mu["blocks.0.attn.qkv.weight"].any():
        raise AssertionError(f"moments after compress: not zero in {dirty}")
    want_dims = []
    for i, bs in enumerate(space.blocks):
        (h, c), ml = B.FORCED_CELLS[i % len(B.FORCED_CELLS)]
        want_dims.append((bs.attn.head_list[h], bs.attn.chan_counts[c],
                          int(bs.mlp.cell_sizes[ml])))
    log(f"lifecycle compress: {len(report.events)} events, converged; host "
        f"{ms:.2f} ms for the converging pass, {idle_ms:.2f} ms for a pass "
        f"with nothing to prune")

    # 6.2 two postsearch steps, Mixup on; decoder and mask token frozen
    post = B.build_postsearch_step(bundle, batch)
    frozen = {n: p.detach().clone() for n, p in leaves.items()
              if n.startswith("decoder.") or n == "mask_token"}
    for _ in range(2):
        state, m = post(state, images, labels, gen, 0.75)
    vals = _finite(m, "lifecycle postsearch step")
    log("lifecycle postsearch metrics: " + json.dumps(vals))
    leaves = named_leaves(state.params, state.alphas)
    if {n: id(p) for n, p in leaves.items()} != objects or \
            {n: id(t) for n, t in state.opt_state.mu.items()} != moments:
        raise AssertionError("compress or a step re-allocated the model")
    if len(frozen) != 3 or not all(torch.equal(leaves[n], t)
                                   for n, t in frozen.items()):
        raise AssertionError("postsearch moved the decoder or the mask token")

    # 6.3 fuse; gated == fused, fp32 logits on one batch
    x, y = images[0], labels[0]
    fused, farch = fuse_params(state.params, state.arch, space, cfg)
    kw = dict(train=False, use_mim=False, compute_dtype=torch.float32)
    with torch.no_grad():
        gated = mim_forward(state.params, state.alphas, state.arch, x, cfg,
                            space, **kw).logits
        sup = mim_forward(fused, state.alphas, farch, x, cfg, space,
                          fused=True, **kw).logits
    e_fused = rel_err(sup, gated)[1]
    ev_gated = make_eval_step(space, cfg)(state.params, state.alphas,
                                          state.arch, x, y)
    ev_fused = make_eval_step(space, cfg, fused=True)(fused, state.alphas,
                                                      farch, x, y)

    # 6.4 export; sliced == fused, fp32 logits on the same batch
    dense, dcfg, meta, fstate, train, evaluate = B.build_subnet_steps(
        bundle, state, batch)
    if dcfg.embed_dim != 336 or list(dcfg.block_overrides) != want_dims:
        raise AssertionError(f"exported dims {dcfg.embed_dim}, "
                             f"{dcfg.block_overrides}; wanted {want_dims}")
    with torch.no_grad():
        sliced = vit_forward(dense, x, dcfg, compute_dtype=torch.float32)
    e_sliced = rel_err(sliced, sup)[1]
    ev_sliced = evaluate(dense, x, y)
    losses = [e["loss_sum"].item() / batch
              for e in (ev_gated, ev_fused, ev_sliced)]
    log(f"lifecycle gated == fused == sliced, fp32 logits on the card: fused "
        f"vs gated rel {e_fused:.3e}, sliced vs fused rel {e_sliced:.3e} (tol "
        f"{TOL_LOGITS:g}); bf16 eval loss gated {losses[0]:.5f}, fused "
        f"{losses[1]:.5f}, sliced {losses[2]:.5f}")
    if not (e_fused <= TOL_LOGITS and e_sliced <= TOL_LOGITS):
        raise AssertionError("gated, fused and sliced logits disagree")
    # bf16 forwards of three forms of one model: 2% of the loss
    if not all(math.isfinite(v) and abs(v - losses[1]) <= 2e-2 * losses[1]
               for v in losses):
        raise AssertionError(f"bf16 eval losses disagree: {losses}")
    take_counts()

    # 6.5 dense train steps and eval steps on the subnet, counted from 0
    fstate, m = train(fstate, images, labels, gen)         # first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fstate, m = train(fstate, images, labels, gen)
    loss = _finite(m, "subnet train step")["loss"]
    dt_train = (time.perf_counter() - t0) / steps
    got_train = take_counts()
    ev = evaluate(dense, x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        ev = evaluate(dense, x, y)
    _finite(ev, "subnet eval step")
    dt_eval = (time.perf_counter() - t0) / steps
    got_eval = take_counts()

    N = cfg.num_patches + cfg.num_tokens
    blocks = {"resident": 0, "general": 0}
    for _, d, _ in dcfg.block_overrides:
        blocks[A.attention_body(N, d, torch.bfloat16).name] += 1
    micro = steps + 1
    per_body = {b: n * micro for b, n in blocks.items()}
    want_train = {"attention_fwd": per_body, "attention_bwd": per_body}
    want_eval = {"attention_fwd": per_body,
                 "attention_bwd": {"resident": 0, "general": 0}}
    if got_train != want_train or got_eval != want_eval:
        raise AssertionError(
            f"subnet launches by body: train {got_train} (expected "
            f"{want_train}), eval {got_eval} (expected {want_eval})")
    odd = [d for _, d, _ in dcfg.block_overrides if d % 16]
    if blocks != {"resident": cfg.depth, "general": 0} or not odd \
            or len(odd) == cfg.depth:
        raise AssertionError(f"the subnet's blocks by body {blocks}, head "
                             f"dims 8 * odd {odd}: expected every block "
                             f"resident and a mixed geometry")
    log(f"lifecycle subnet: D {dcfg.embed_dim}, blocks (heads, head dim, "
        f"mlp) {list(dcfg.block_overrides)}; {blocks['resident']} blocks "
        f"take the resident body ({len(odd)} of them at head dims 8 * odd), "
        f"{blocks['general']} the general; launches "
        f"over {micro} train microbatches {got_train}, over {micro} eval "
        f"batches {got_eval}")
    log(f"lifecycle subnet rates on {card}, batch {batch}, bf16: train step "
        f"{batch / dt_train:.2f} img/s ({dt_train * 1e3:.2f} ms/step, loss "
        f"{loss:.4f}), eval step {batch / dt_eval:.2f} img/s "
        f"({dt_eval * 1e3:.2f} ms/step) over {steps} steps each")
    return {"attention_fwd": totals["attention_fwd"]["resident"],
            "attention_bwd": totals["attention_bwd"]["resident"],
            "attention_fwd_general": totals["attention_fwd"]["general"],
            "attention_bwd_general": totals["attention_bwd"]["general"]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ofb_tpu_torch.ops import attention as A
    from ofb_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = cuda_build.build()
    log(f"build: {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for path in libs.values():
        for line in ptxas_report(path.with_suffix(".log").read_text()):
            print(f"  {path.name}: {line}", file=sys.stderr)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = check_kernels(A)
    times = time_kernels(A)
    subnet_times = time_subnet_shapes(A)
    fp32 = check_against_cpu(A)
    launches = run_slice(A)
    lifecycle = run_lifecycle(A, smi)

    kernels = []
    for name, src, line in (
            ("attention_fwd", "attention_fwd_resident.cu", 68),
            ("attention_bwd", "attention_bwd_resident.cu", 81),
            ("attention_fwd_general", "attention_fwd.cu", 68),
            ("attention_bwd_general", "attention_bwd.cu", 81)):
        kernels.append(dict(
            name=name, route="cuda", source=f"ofb_tpu_torch/csrc/{src}",
            replaces=f"{ATTN_SRC}:{line}",
            launches=fp32[name] + launches[name] + lifecycle[name],
            launches_fp32=fp32[name],
            launches_search=launches[name],
            launches_lifecycle=lifecycle[name],
            max_abs_err=errs[name], **times[name]))
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels no driven path launched: {idle}")
    log(json.dumps({"subnet_attention": subnet_times}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
