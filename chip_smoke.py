#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ofb_tpu_torch) on one GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each of
which raises (and so exits non-zero) on failure:

  1. card: name and power limit, CUDA version, and the build of every
     kernel from ofb_tpu_torch/csrc (one nvcc per source, in parallel);
  2. kernels: each kernel's wrapper against its plain PyTorch twin on the
     same inputs, both bodies (the resident `wgmma` one and the general
     one, each asked for by name), at the DeiT-S shapes of the search step
     and at ragged shapes, in bf16 and fp32 (TF32 off);
  3. timing: both bodies of each kernel with CUDA events at batch 256, in
     turns (general, resident, resident, general), beside the bound, the
     plain twin and torch's scaled_dot_product_attention (timed here as a
     yardstick only; the port never calls it); the resident body also at
     batch 64;
  4. reference: the port's DeiT-S forward and backward on the card (fp32,
     kernels) against the same model on the CPU (fp32, plain twins);
  5. the slice: the DeiT-S search step at full width on the card, bf16,
     batch 64: finite losses, and the attention kernels launched exactly
     12 + 12 times per microbatch, counted from 0, all through the
     resident body.

The line before the last is the kernels' JSON; the last line is
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
# the resident body: bf16, N <= 256, d a multiple of 16
RESIDENT = [DEIT_S, (2, 197, 6, 32), (2, 197, 3, 128), (2, 50, 4, 32),
            (2, 256, 2, 64), (3, 17, 2, 16)]
# the general body: everything else, and DeiT-S when asked for by name
GENERAL = [DEIT_S, (2, 257, 2, 64), (3, 17, 2, 16), (2, 33, 3, 24),
           (2, 70, 2, 40)]
TIMING = (256, 197, 6, 64)
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
        t_bytes = bytes_[name] / HBM_BYTES_PER_S * 1e3
        t_ops = flops[name] / BF16_FLOPS * 1e3
        shared = dict(plain_ms=cuda_time_ms(plain[name]),
                      library_ms=cuda_time_ms(library[name]),
                      bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations")
        out[name] = dict(ms=ms["resident"], **shared)
        out[name + "_general"] = dict(ms=ms["general"], **shared)
        log(f"timing {name} B={B} bf16: turns " +
            ", ".join(f"{b} {t:.4f}" for b, t in turns) + f" ms; resident "
            f"{ms['resident']:.4f} ms is {ms['general'] / ms['resident']:.2f}x "
            f"faster than general {ms['general']:.4f} ms; plain "
            f"{shared['plain_ms']:.4f} ms, sdpa {shared['library_ms']:.4f} "
            f"ms, bound {shared['bound_ms']:.4f} ms ({shared['bound_by']})")
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


def check_against_cpu():
    """Phase 4: the port's DeiT-S (full width, 12 blocks) forward and
    gradients on the card (fp32, CUDA kernels) against the same model on
    the CPU (fp32, plain twins), on 2 images with a fixed mask."""
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
    (lc, dc, gc), (lg, dg, gg) = res["cpu"], res["cuda"]
    # fp32 on both devices; 12 blocks of other summation orders
    e_logits = rel_err(lg, lc)[1]
    e_grads = rel_err(gg, gc)[1]
    log(f"reference DeiT-S fp32 card vs CPU: logits rel {e_logits:.3e}, "
        f"decoder loss {dg:.6f} vs {dc:.6f}, grads rel {e_grads:.3e}")
    if not (e_logits < 1e-3 and abs(dg - dc) <= 1e-4 * abs(dc)
            and e_grads < 1e-3 and math.isfinite(dg)):
        raise AssertionError("the port on the card disagrees with the CPU")


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
    check_against_cpu()
    launches = run_slice(A)

    kernels = []
    for name, src, line in (
            ("attention_fwd", "attention_fwd_resident.cu", 68),
            ("attention_bwd", "attention_bwd_resident.cu", 81),
            ("attention_fwd_general", "attention_fwd.cu", 68),
            ("attention_bwd_general", "attention_bwd.cu", 81)):
        kernels.append(dict(
            name=name, route="cuda", source=f"ofb_tpu_torch/csrc/{src}",
            replaces=f"{ATTN_SRC}:{line}", launches=launches[name],
            max_abs_err=errs[name], **times[name]))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
