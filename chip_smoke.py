#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ofb_tpu_torch) on one GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each of
which raises (and so exits non-zero) on failure:

  1. card: name and power limit, CUDA version, and the build of every
     kernel from ofb_tpu_torch/csrc (one nvcc per source, in parallel);
  2. kernels: each kernel's wrapper against its plain PyTorch twin on the
     same inputs, all three bodies (the resident and the streaming `wgmma`
     ones and the general one, each asked for by name), at the DeiT-S
     shapes of the search step, the exported subnet's shapes (head dims
     8 * odd among them, which the `wgmma` bodies run zero-padded to the
     next multiple of 16), ragged shapes and head dims that are not a
     multiple of 8 (4, 6, 12, 36: the general body's alone), in bf16 and
     fp32 (TF32 off), the general body also on views whose rows start one
     element into a wider buffer (no row 16-byte aligned);
     the streaming body at DeiT-S and DeiT-B at 384 pixels (577 tokens),
     ragged token counts up to 1025, 8 * odd head dims at 577 and, named,
     at 1, 17 and 197 tokens; every output finite; then the streaming
     pair's determinism at DeiT-S-384 and ViT-H/14 (STREAM_REPEAT): a
     second call, and a CUDA graph of forward + backward replayed, equal
     the first eager call bit for bit;
  3. timing: both bodies of each kernel with CUDA events at batch 256, in
     turns (general, resident, resident, general), beside the bound, the
     plain twin and torch's scaled_dot_product_attention (timed here as a
     yardstick only; the port never calls it); the resident body also at
     batch 64; then at each attention shape of the exported subnet, batch
     256: resident, general (asked for by name), twin and SDPA. Each of
     these also as device time (torch.profiler: the kernels' summed
     durations, the host's dispatch left out; a session that lost kernel
     records is run again). At 577 tokens (DeiT-S and DeiT-B at 384
     pixels, and an exported subnet's 2 x 24 head) the general and the
     streaming bodies in turns the same way, beside the twin, SDPA, the
     bytes and the operations bounds; the streaming body must be the
     faster at DeiT-S (its ratio to SDPA is printed, not asserted: timing
     noise across cards would fail honest runs). Then each attention shape
     of the ViT family (VIT_SHAPES: ViT-H/14, ViT-L/16 at 384, the 8 x 96
     vit_small, ViT-B/16 and /32) at the batch of phase 10's runs: its
     body, the twin and SDPA beside the bound; and the general body in
     fp32, the type it serves,
     at DeiT-S at 224 and 384 pixels beside the twin, SDPA in fp32 and the
     fp32 bound (the CUDA cores' 67 TFLOP/s), its ratios to SDPA and to the
     bound printed; it must be faster than the twin by device time there;
  4. reference: the port's DeiT-S forward and backward on the card (fp32,
     kernels) against the same model on the CPU (fp32, plain twins); the
     card's pass is a driven path of its own, counted from 0: 12 + 12
     launches, all through the general body (fp32); then a subnet with
     head dims 4, 6, 12 and 36 (DeiT-S's width, 4 blocks): two dense train
     steps and an eval step in fp32 on the card against the CPU, its 12 + 8
     launches all general;
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
     56 among them, through the resident body, none through the general;
  7. the CLIs, in process through each one's parser and `main`, DeiT-S at
     full width and depth, batch 64, bf16, SYNTHETIC data at staging 256:
     `cli.search` (fused RandAugment m9 + erasing, Mixup / CutMix after the
     finish, compress threshold 1.0; 4 epochs: search, the finish,
     postsearch, the fuse of the best checkpoint), a resumed fifth epoch,
     `cli.export` of the best checkpoint, one `cli.finetune` epoch of the
     subnet (EMA, device cache) and `cli.eval` of its best. Checks the
     artifacts, log.txt's keys against the JAX CLI's, finite losses,
     accuracies in [0, 100], and each run's attention launches counted from
     0 against what `attention_body` predicts (all resident, none general);
     prints each run's sustained epoch img/s and the split of its epochs,
     the compress passes' host ms, and the device time of
     `apply_train_augment` at batch 256 next to the search step's;
  8. the 384-pixel path, in process through the CLIs, bf16, batch 64,
     SYNTHETIC at staging 256: `cli.finetune --model deit_small_patch16_384
     --input-size 384 --from-scratch` for one epoch (device cache) and
     `cli.eval` of its best; then phase 7's exported subnet finetuned for
     one epoch at `--input-size 384` (its pos-embed resized 197 -> 577)
     and evaluated. Every attention launch of the four runs, counted from
     0, must take the streaming body (577 tokens), none the resident or
     the general.

  9. the planned path (the epoch's plan on the device, each step one CUDA
     graph replay), DeiT-S at full width and depth, bf16, batch 64, from a
     device cache of uint8 staging images: (a) the planned search step's
     warm-up, capture and replays against eager runs of the same planned
     function from the same state and generator seed (ArchState
     bit-identical, the metrics and every other tensor of the state within
     1e-3 of the leaf's largest magnitude, the largest difference printed),
     then the same for the planned postsearch step after a forced
     convergence and the planned train step of the exported subnet;
     (b) a profiler trace of one replay of the search and of the train step
     counts 12 + 12 attention launches, all on the resident body, and the
     counters (a replay adds its capture's launches) agree; (c) in process
     through the CLIs: `cli.search --cache-device --planned-epoch` (search,
     compress, the finish, the planned postsearch step, the fuse),
     `cli.finetune --cache-device --planned-epoch --distillation-type hard
     --teacher-model regnety_160` of phase 7's export (a seeded RegNetY-160
     teacher in every step) and `cli.search --pretrained_path` from a DeiT-S
     state dict written from a seed; each run's launches counted from 0
     (replays included), its captures and replays, and its epoch img/s
     beside phase 7's classic runs.
 10. the ViT family and the JAX package's TPU checkpoints: (a) the TPU
     searches committed in runs/ (two DeiT-S, one DeiT-B), their alphas and
     arch state read from the msgpack files by the port's reader (their
     params, listed but not committed, must raise), force-finished from
     seeded weights and exported (the DeiT-S ones to the subnets their TPU
     finetunes recorded), each subnet's train and eval steps timed over 4
     calls after a warm-up at batch 64, bf16, all on the resident body; the
     dense model of a TPU finetune's meta, one eval batch; (b) in process
     through the CLIs, SYNTHETIC 1024 at staging 256, bf16: `cli.finetune
     --from-scratch --cache-device` one epoch and `cli.eval` of its best
     for ViT-B/16 (batch 64, resident body), ViT-L/16 at 384 and ViT-H/14
     (batch 32, streaming body); one eval batch of the in21k ViT-B/16
     (pre-logits), the MIIL ViT-B/16 (no qkv bias) and the 8 x 96
     vit_small, and their fp32 logits and gradients on the card against
     the CPU's. No bf16 run launches the general body.

 11. the Swin family (`run_swin`), Swin-T with per-stage widths at full
     width and depth: the fp32 gated forward and backward on the card
     against the CPU at batch 2; bf16 search steps at batch 64, a forced
     compress to convergence, postsearch steps, the export, fp32 gated ==
     fused == sliced, the subnet's train and eval steps; the planned
     search step as a graph replay against eager; `cli.search_swin
     --embed_search --cache-device --planned-epoch --force-finish
     --export-finetune-epochs 1`, `cli.eval` of its best/ and
     model_exported and one `cli.train_swin_dense` epoch; the two TPU
     searches of runs/ladder_swin_r5 exported on the card to their
     committed widths. Swin's window attention is plain PyTorch, as in the
     JAX package: the phase asserts that no attention kernel launched.
 12. data parallelism over torch.distributed (`run_dist`), DeiT-S at full
     width and depth, bf16, a global batch of 64, each part in processes
     of its own (this file run with a role): (a) a world of one over NCCL
     with torchrun's environment: the search step from one state and
     generator seed without a group and under NCCL (ArchState
     bit-identical, every other tensor within TOL_GRAPH), the all-reduce
     of the step's gradient bucket timed, the planned search step's CUDA
     graph (the all-reduce captured in it) against eager calls; (b) under
     `python -m torch.distributed.run --standalone --nproc_per_node 1`:
     `cli.search` (SYNTHETIC 256, compress threshold 1.0: search, the
     finish, postsearch, the fuse of best/), `cli.export`, one
     `cli.finetune` epoch and `cli.eval`, each reporting rank 0 of a world
     of 1 on NCCL, its launches counted from 0 (all resident), the search
     epochs' img/s beside phase 7's; (c) two ranks sharing the card over
     gloo (a correctness run: gloo stages card tensors through the host),
     each with its half of the global batch: two search steps, a compress
     pass on alphas crafted on rank 0 only, an eval of its half of a val
     set; the ranks' weights, compress digests and eval statistics equal,
     the weights within TOL_GRAPH of one process's two steps on the whole
     batch (a leaf that starts at 0 holds only its two Adam updates of
     about +-lr, which a bf16 gradient of another rounding flips: there
     within twice the furthest such a leaf moved), the eval equal to one
     process's over the whole set; each
     rank's 24 + 24 step and 12 eval launches, resident. A process that
     fails or outlasts DIST_TIMEOUT fails the phase.

The line before the last is the kernels' JSON (`launches` sums the nine
driven paths, `launches_fp32`, `launches_search`, `launches_lifecycle`,
`launches_cli`, `launches_384`, `launches_planned`, `launches_vit`,
`launches_swin` (0) and `launches_dist` (phase 12's processes) give each;
the general body's times are fp32's); the
last line is {"ok": true,
"device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_FLOPS = 989e12              # H100 SXM, dense
FP32_FLOPS = 67e12               # H100 SXM, the CUDA cores' fp32 FMA
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
# head dims off multiples of 8 (a tiny search exports 4 .. 16), which only
# the general body takes: DeiT's 197 tokens, a Swin window with its cls,
# DeiT at 384 pixels, a ragged count
SMALL_HEADS = [(2, 197, 2, 12), (3, 50, 3, 6), (2, 577, 2, 36), (3, 17, 1, 4)]
# the general body: unaligned views, fp32 and head dims off multiples of 8;
# asked for by name at the resident and the streaming bodies' shapes too
GENERAL = [DEIT_S, (2, 257, 2, 64), (2, 577, 2, 64)] + RAGGED + SUBNET \
    + SMALL_HEADS
# ... and as views whose rows start one element into a wider buffer, so that
# no row is 16-byte aligned (the 4-byte copies of the fp32 kernels)
GENERAL_UNALIGNED = SMALL_HEADS + [(2, 197, 2, 64), (3, 17, 2, 40)]
# the streaming body: DeiT-S and DeiT-B at 384 pixels (577 = 4 x 128 + 65
# keys in the forward's tiles, 9 x 64 + 1 in the backward's), ragged token
# counts (1025 = 8 x 128 + 1: the forward's 16-key last tile; 17 backward
# tiles through rings of 6 and 8), an exported subnet's head dims at 577
# (24, 40, 56 in one 64-column panel; 72 and 120 with tails of 16 and 64
# columns) and, asked for by name, counts the resident body serves
STREAMING = [(64, 577, 6, 64), (16, 577, 12, 64), (2, 257, 2, 64),
             (2, 300, 2, 64), (2, 385, 3, 32), (2, 1025, 2, 64),
             (2, 577, 2, 24), (2, 577, 2, 40), (2, 577, 2, 56),
             (2, 577, 2, 72), (2, 577, 2, 120), (3, 1, 2, 64),
             (3, 17, 2, 40), (2, 197, 6, 64)]
# the ViT family's attention shapes at the batches of phase 10's runs, and
# the body that serves each in bf16: ViT-H/14 at 224 (d 80: a 64-column
# panel and a 16-column tail), ViT-L/16 at 384, the JAX package's
# vit_small (8 x 96, the resident dq + dk/dv backward), ViT-B/16, ViT-B/32
# at 384 and at 224
VIT_SHAPES = [((32, 257, 16, 80), "streaming"),
              ((32, 577, 16, 64), "streaming"),
              ((64, 197, 8, 96), "resident"), ((64, 197, 12, 64), "resident"),
              ((64, 145, 12, 64), "resident"), ((64, 50, 12, 64), "resident")]
RESIDENT += [shape for shape, body in VIT_SHAPES if body == "resident"]
# ... and ViT-H/14 at 384: 27 x 27 patches + 1 = 730 tokens
STREAMING += [shape for shape, body in VIT_SHAPES if body == "streaming"] + [
    (2, 730, 16, 80)]
TIMING = (256, 197, 6, 64)
# the general body in fp32, the type it serves on the driven paths: DeiT-S
# at 224 and at 384 pixels
FP32_TIMING = [(256, 197, 6, 64), (256, 577, 6, 64)]
# the streaming body against the general one: DeiT-S and DeiT-B at 384
# pixels (the batches of the search step at 224), an exported subnet's
# narrowest head
STREAM_TIMING = [(256, 577, 6, 64), (64, 577, 12, 64), (256, 577, 2, 24)]
BODIES = ("resident", "streaming", "general")
# fp32 logits of two forms of one model on the card, as max |a - b| over
# max |b|: 12 blocks of fp32 sums in other orders (TF32 off)
TOL_LOGITS = 1e-4
# graph replays of a planned step against eager runs of the same function,
# as max |graph - eager| / max |eager| per leaf: the same kernels on the same
# inputs (bit-identical expected), with room for a library kernel that sums
# with atomics in another order
TOL_GRAPH = 1e-3
# the classic CLI runs' epoch img/s (phase 7), printed beside the planned
RATES = {}
ATTN_SRC = "ofb_tpu/ops/pallas_attention.py"


def log(*a):
    print(*a, flush=True)


def by_body(A):
    """The attention launches since the last reset, by wrapper and body."""
    return {"attention_fwd": dict(A.attention_fwd.by_body),
            "attention_bwd": dict(A.attention_bwd.by_body)}


def kernel_counts(counts):
    """{kernel name of the JSON line: launches} from launches by wrapper
    and body (the resident body's kernels carry the wrapper's name)."""
    return {w + ("" if body == "resident" else "_" + body): n
            for w, by in counts.items() for body, n in by.items()}


def only(body, fwd, bwd):
    """Launches by wrapper and body with every launch on `body`."""
    return {"attention_fwd": {b: fwd if b == body else 0 for b in BODIES},
            "attention_bwd": {b: bwd if b == body else 0 for b in BODIES}}


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


# profiler sessions of `device_time_ms`, by how each was judged, and the
# times that fell back to `queued_time_ms`
SESSIONS = {"whole": 0, "agreed": 0, "dropped": 0, "queued": 0}


def device_time_ms(fn, iters=20, warmup=3, tries=3):
    """Device time of one call of `fn`: the summed durations of the kernels
    it launched over `iters` calls, from torch.profiler, divided by
    `iters`. Unlike `cuda_time_ms` it leaves out the host's dispatch, which
    at small shapes takes longer than the kernel and so sets the pace of
    back-to-back calls.

    A profiler session on the card can lose some or all of its kernel
    records. A session is taken when its kernel count is a whole multiple
    of `iters` (what a `fn` that launches the same kernels at every call
    gives), or when it counts within 1% of an earlier session's (a `fn`
    whose launches vary a little from call to call); otherwise it is
    dropped and run again, up to `tries` sessions. If none is taken, the
    time is `queued_time_ms`'s. The log gives the counts of every call
    that needed more than one session."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        n = sum(e.count for e in kernels)
        us = sum(e.device_time_total for e in kernels)
        counts.append(n)
        taken = None
        if n > 0 and us > 0:
            if n % iters == 0:
                taken = "whole"
            elif any(abs(m - n) <= m // 100 for m in counts[:-1]):
                taken = "agreed"
        if taken:
            SESSIONS[taken] += 1
            if len(counts) > 1:
                log(f"device time: sessions of {iters} calls counted "
                    f"{counts} kernels; the last taken ({taken})")
            return us / iters / 1e3
        SESSIONS["dropped"] += 1
    ms = queued_time_ms(fn, iters)
    SESSIONS["queued"] += 1
    log(f"device time: sessions of {iters} calls counted {counts} kernels, "
        f"none taken; {ms:.4f} ms from queued_time_ms used")
    return ms


def queued_time_ms(fn, iters):
    """CUDA-event time of one of `iters` calls that the host queued while
    the card ran a sleeping kernel, so that they run back to back: the
    device's time with the gaps between its kernels, the host's dispatch
    left out (unless `fn` waits for the card)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10 ** 7 / start.elapsed_time(end)
    torch.cuda._sleep(int(3 * host_ms * cycles_per_ms) + 1)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(log_text):
    """One line a kernel from nvcc's `-Xptxas -v` output: its name with its
    template arguments, registers a thread and spilled bytes; and every
    warning (ptxas says there when it serialises `wgmma`)."""
    name = None
    spills = ""
    for line in log_text.splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            yield line.strip()
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


def make_qkv(B, N, H, d, dtype, gen, offset=0):
    """q pre-scaled and contiguous, k and v strided views of a
    (B, N, 3, H, d) buffer: what the search step hands the kernels. With
    offset > 0 all three are views that start `offset` elements into the
    rows of a (B, N, 3, H, d + offset) buffer: no row is 16-byte aligned."""
    import torch
    if offset:
        buf = torch.randn((B, N, 3, H, d + offset), generator=gen,
                          device="cuda").to(dtype)
        buf[:, :, 0] = (buf[:, :, 0].float() * d ** -0.5).to(dtype)
        return tuple(buf[:, :, i, :, offset:] for i in range(3))
    buf = torch.randn((B, N, 3, H, d), generator=gen, device="cuda").to(dtype)
    q = (buf[:, :, 0].float() * d ** -0.5).to(dtype)
    return q, buf[:, :, 1], buf[:, :, 2]


def rel_err(got, ref, scale=1e-30):
    """max |got - ref| and it over max |ref| (over `scale` where ref is
    all zeros)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), scale)


def uncancelled_scales(q, k, v, do):
    """max |(p ⊙ dp) k| and max |(p ⊙ dp)ᵀ q|: dq and dk without the
    delta that cancels them. With one token, softmax has no gradient (p =
    1, ds = p ⊙ (dp - delta) = 0) and the twin's dq and dk are exactly 0;
    the kernels take dp = do vᵀ and delta = rowsum(do ⊙ o) as two sums in
    different orders, so they cancel to fp32 rounding, and their error is
    measured against what it cancels."""
    import torch
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qf, kf), dim=-1)
    pdp = p * torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    return (torch.einsum("bhnm,bmhd->bnhd", pdp, kf).abs().max().item(),
            torch.einsum("bhnm,bnhd->bmhd", pdp, qf).abs().max().item(),
            1e-30)


def check_kernels(A):
    """Phase 2. Returns the max abs errors of the resident body at the
    search step's shape and type (DeiT-S, bf16), of the general body at
    that shape in fp32 (the type it serves) and of the streaming body at
    DeiT-S at 384 pixels, batch 64."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(shape, torch.bfloat16, "resident") for shape in RESIDENT]
    cases += [(shape, torch.bfloat16, "streaming") for shape in STREAMING]
    cases += [(shape, dtype, "general") for shape in GENERAL
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [(shape, dtype, "general", 1) for shape in GENERAL_UNALIGNED
              for dtype in (torch.bfloat16, torch.float32)]
    main_err = {}
    for shape, dtype, body, *offset in cases:
        q, k, v = make_qkv(*shape, dtype, gen, *offset)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        fit = A.attention_body(shape[1], shape[3], dtype).name
        if body == "resident" and fit != body or \
                body == "streaming" and shape[1] > 256 and fit != body:
            raise AssertionError(f"{shape} {dtype} is not the {body} body's")
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
        scales = uncancelled_scales(q, k, v, do) if shape[1] == 1 \
            else (1e-30,) * 3
        bwd = [rel_err(g, r, c) for g, r, c in zip((dq, dk, dv), ref, scales)]
        view = " unaligned views" if offset else ""
        log(f"kernels {body} {shape} {dtype}{view}: fwd rel {fwd[1]:.3e}, lse "
            f"abs {lse_err:.3e}, bwd rel " +
            ", ".join(f"{e[1]:.3e}" for e in bwd) + f" (tol {tol:g})")
        if not (fwd[1] <= tol and lse_err <= 1e-3
                and max(e[1] for e in bwd) <= tol):
            raise AssertionError(f"the {body} body disagrees with its twin "
                                 f"at {shape} {dtype}{view}")
        if offset:
            continue
        if shape == DEIT_S and body == "resident" \
                or shape == STREAMING[0] and body == "streaming" \
                or shape == DEIT_S and body == "general" \
                and dtype == torch.float32:
            tag = "" if body == "resident" else "_" + body
            main_err["attention_fwd" + tag] = fwd[0]
            main_err["attention_bwd" + tag] = max(e[0] for e in bwd)
    return main_err


# the streaming body's repeat and graph-replay checks (phase 2): DeiT-S at
# 384 pixels (batch 64) and ViT-H/14 (d = 80: the 16-column tail, and 257 =
# 2 x 128 + 1 tokens: the forward's 16-key last tile)
STREAM_REPEAT = [(64, 577, 6, 64), (32, 257, 16, 80)]


def check_streaming_repeats(A):
    """Phase 2, continued: the streaming pair is deterministic. Two eager
    forward + backward calls on the same inputs give bit-identical o, lse,
    dq, dk and dv, and the same pair captured in a CUDA graph and replayed
    gives the eager outputs bit for bit (the tensor maps are encoded from
    the captured call's own pointers)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(12)
    names = ("o", "lse", "dq", "dk", "dv")
    for shape in STREAM_REPEAT:
        q, k, v = make_qkv(*shape, torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen,
                         device="cuda").to(torch.bfloat16)

        def pair():
            o, lse = A.attention_fwd(q, k, v, body="streaming")
            return (o, lse) + A.attention_bwd(q, k, v, o, lse, do,
                                              body="streaming")
        first, second = pair(), pair()
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            pair()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = pair()
        graph.replay()
        torch.cuda.synchronize()
        for what, got in (("a second eager call", second),
                          ("the graph replay", captured)):
            differ = [n for n, a, b in zip(names, first, got)
                      if not torch.equal(a, b)]
            if differ:
                raise AssertionError(
                    f"streaming body at {shape}: {what} differs from the "
                    f"first eager call in {differ}")
        del graph
        log(f"kernels streaming {shape} bf16: a second call and a CUDA "
            f"graph replay of forward + backward equal the first call bit "
            f"for bit (o, lse, dq, dk, dv)")


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


def time_streaming(A):
    """Phase 3, continued: at each shape of STREAM_TIMING, bf16, the
    general and the streaming bodies of each kernel in turns (general,
    streaming, streaming, general; each figure the mean of its two turns),
    the plain twin and SDPA, each also as device time, beside the bytes
    and the operations bounds; for the backward also the streaming design's
    own floor (it computes 14 B H N² d flops for the math's 10). Returns
    the rows and, at the first shape, the kernels' JSON fields of both
    bodies."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows, fields = [], {}
    for B, N, H, d in STREAM_TIMING:
        q, k, v = make_qkv(B, N, H, d, torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen,
                         device="cuda").to(torch.bfloat16)
        o, lse = A.attention_fwd(q, k, v)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qg, kg, vg = (t.detach().clone().requires_grad_()
                      for t in (qt, kt, vt))
        so = F.scaled_dot_product_attention(qg, kg, vg, scale=1.0)
        sdo = do.transpose(1, 2)
        calls = {}
        for b in ("streaming", "general"):
            calls["fwd_" + b] = lambda b=b: A.attention_fwd(q, k, v, body=b)
            calls["bwd_" + b] = lambda b=b: A.attention_bwd(
                q, k, v, o, lse, do, body=b)
        calls.update(
            fwd_plain=lambda: A.attention_fwd_reference(q, k, v),
            bwd_plain=lambda: A.attention_bwd_reference(q, k, v, do),
            fwd_sdpa=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=1.0),
            bwd_sdpa=lambda: torch.autograd.grad(
                so, (qg, kg, vg), sdo, retain_graph=True))
        elems, sq = B * N * H * d, B * H * N * N * d
        row = dict(shape=[B, N, H, d])
        for n, nbytes, flops in (("fwd", 8 * elems, 4 * sq),
                                 ("bwd", 14 * elems, 10 * sq)):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS * 1e3
            row.update({f"{n}_bytes_bound_ms": t_bytes,
                        f"{n}_ops_bound_ms": t_ops,
                        f"{n}_bound_ms": max(t_bytes, t_ops),
                        f"{n}_bound_by": "bytes" if t_bytes >= t_ops
                        else "operations"})
            turns = [(b, cuda_time_ms(calls[f"{n}_{b}"], iters=10))
                     for b in ("general", "streaming", "streaming",
                               "general")]
            for b in ("streaming", "general"):
                row[f"{n}_{b}_ms"] = sum(t for x, t in turns if x == b) / 2
            for b in ("plain", "sdpa"):
                row[f"{n}_{b}_ms"] = cuda_time_ms(calls[f"{n}_{b}"],
                                                  iters=10)
        row["bwd_design_floor_ms"] = 14 * sq / BF16_FLOPS * 1e3
        for key, call in calls.items():
            row[key + "_device_ms"] = device_time_ms(call, iters=10)
        rows.append(row)
        log(f"timing {(B, N, H, d)} bf16, ms (device ms): " + "; ".join(
            f"{n} " + ", ".join(
                f"{b} {row[f'{n}_{b}_ms']:.4f} "
                f"({row[f'{n}_{b}_device_ms']:.4f})"
                for b in ("streaming", "general", "plain", "sdpa"))
            + f", bound {row[n + '_bound_ms']:.4f} ({row[n + '_bound_by']}; "
            f"bytes {row[n + '_bytes_bound_ms']:.4f}, operations "
            f"{row[n + '_ops_bound_ms']:.4f})" for n in ("fwd", "bwd"))
            + f"; the streaming backward's own floor "
            f"{row['bwd_design_floor_ms']:.4f} ms; streaming over SDPA: "
            + ", ".join(
                f"{n} {row[f'{n}_streaming_ms'] / row[f'{n}_sdpa_ms']:.3f} ("
                + format(row[f"{n}_streaming_device_ms"]
                         / row[f"{n}_sdpa_device_ms"], ".3f") + ")"
                for n in ("fwd", "bwd")) + " (events (device); not asserted)")
        if (B, N, H, d) != STREAM_TIMING[0]:
            continue
        for n in ("fwd", "bwd"):
            if row[f"{n}_streaming_ms"] >= row[f"{n}_general_ms"]:
                raise AssertionError(f"attention_{n} at {(B, N, H, d)}: the "
                                     f"streaming body is not faster than "
                                     f"the general one")
            for b in ("streaming", "general"):
                fields[f"attention_{n}_{b}"] = dict(
                    shape=row["shape"], ms=row[f"{n}_{b}_ms"],
                    device_ms=row[f"{n}_{b}_device_ms"],
                    plain_ms=row[f"{n}_plain_ms"],
                    library_ms=row[f"{n}_sdpa_ms"],
                    plain_device_ms=row[f"{n}_plain_device_ms"],
                    library_device_ms=row[f"{n}_sdpa_device_ms"],
                    bound_ms=row[f"{n}_bound_ms"],
                    bound_by=row[f"{n}_bound_by"])
        fields["attention_bwd_streaming"]["design_floor_ms"] = \
            row["bwd_design_floor_ms"]
    return rows, fields


def _attention_calls(A, q, k, v, do, body):
    """{name: call} of one shape: the kernels of `body`, the plain twins
    and SDPA, forward and backward."""
    import torch
    import torch.nn.functional as F
    o, lse = A.attention_fwd(q, k, v, body=body)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (qt, kt, vt))
    so = F.scaled_dot_product_attention(qg, kg, vg, scale=1.0)
    sdo = do.transpose(1, 2)
    return {
        "fwd_kernel": lambda: A.attention_fwd(q, k, v, body=body),
        "bwd_kernel": lambda: A.attention_bwd(q, k, v, o, lse, do, body=body),
        "fwd_plain": lambda: A.attention_fwd_reference(q, k, v),
        "bwd_plain": lambda: A.attention_bwd_reference(q, k, v, do),
        "fwd_sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                           scale=1.0),
        "bwd_sdpa": lambda: torch.autograd.grad(so, (qg, kg, vg), sdo,
                                                retain_graph=True)}


def _bounds(row, B, N, H, d, itemsize, flops_per_s):
    """The bytes and the operations bounds of the forward (q, k, v read, o
    written) and the backward (q, k, v, o, do read; dq, dk, dv written)."""
    elems, sq = B * N * H * d, B * H * N * N * d
    for n, nbytes, flops in (("fwd", 4 * elems * itemsize, 4 * sq),
                             ("bwd", 7 * elems * itemsize, 10 * sq)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / flops_per_s * 1e3
        row.update({f"{n}_bound_ms": max(t_bytes, t_ops),
                    f"{n}_bound_by": "bytes" if t_bytes >= t_ops
                    else "operations"})


def _time_row(row, calls, what):
    for key, call in calls.items():
        row[key + "_ms"] = cuda_time_ms(call, iters=10)
        row[key + "_device_ms"] = device_time_ms(call, iters=10)
    log(f"timing {what}, ms (device ms): " + "; ".join(
        f"{n} " + ", ".join(
            f"{b} {row[f'{n}_{b}_ms']:.4f} ({row[f'{n}_{b}_device_ms']:.4f})"
            for b in ("kernel", "plain", "sdpa"))
        + f", bound {row[n + '_bound_ms']:.4f} ({row[n + '_bound_by']}), "
        f"kernel over SDPA {row[f'{n}_kernel_ms'] / row[f'{n}_sdpa_ms']:.3f} "
        f"({row[f'{n}_kernel_device_ms'] / row[f'{n}_sdpa_device_ms']:.3f})"
        for n in ("fwd", "bwd")))


def time_vit_family(A):
    """Phase 3, continued: each attention shape of the ViT family
    (VIT_SHAPES), bf16, at the batch of phase 10's runs: the body that
    serves it, the plain twin and SDPA, by CUDA events and as device time,
    beside the bound (H100 SXM: HBM rate, dense bf16 peak)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    for (B, N, H, d), body in VIT_SHAPES:
        if A.attention_body(N, d, torch.bfloat16).name != body:
            raise AssertionError(f"{(B, N, H, d)} is not the {body} body's")
        q, k, v = make_qkv(B, N, H, d, torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen,
                         device="cuda").to(torch.bfloat16)
        row = dict(shape=[B, N, H, d], body=body)
        _bounds(row, B, N, H, d, 2, BF16_FLOPS)
        _time_row(row, _attention_calls(A, q, k, v, do, body),
                  f"{(B, N, H, d)} bf16, {body} body")
        rows.append(row)
    return rows


def time_general_fp32(A):
    """Phase 3, continued: the general body in fp32, the type it serves on
    the driven paths (phase 4, phase 6's fp32 checks), at FP32_TIMING,
    beside the plain twin, SDPA in fp32 and the fp32 bound (bytes at the
    HBM rate; operations at the CUDA cores' fp32 peak, since the body runs
    fp32 on them). Returns the rows and the kernels' JSON fields of the
    general body (DeiT-S at 224; its 577-token figures under `_577`)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, fields = [], {}
    for B, N, H, d in FP32_TIMING:
        q, k, v = make_qkv(B, N, H, d, torch.float32, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda")
        row = dict(shape=[B, N, H, d], body="general", dtype="float32")
        _bounds(row, B, N, H, d, 4, FP32_FLOPS)
        _time_row(row, _attention_calls(A, q, k, v, do, "general"),
                  f"{(B, N, H, d)} fp32, general body")
        rows.append(row)
        dev = {n: row[f"{n}_kernel_device_ms"] for n in ("fwd", "bwd")}
        log(f"fp32 general body at {(B, N, H, d)}, device time: " + "; ".join(
            f"{n} {dev[n]:.4f} ms = {dev[n] / row[f'{n}_sdpa_device_ms']:.2f}x "
            f"SDPA, {dev[n] / row[f'{n}_bound_ms']:.2f}x the bound, "
            f"{row[f'{n}_plain_device_ms'] / dev[n]:.2f}x faster than the "
            f"twin" for n in ("fwd", "bwd")))
        slow = [n for n in ("fwd", "bwd")
                if dev[n] >= row[f"{n}_plain_device_ms"]]
        if slow:
            raise AssertionError(f"the fp32 general body's {slow} at "
                                 f"{(B, N, H, d)} is not faster than its "
                                 f"plain twin by device time")
        tag = "" if N == 197 else f"_{N}"
        for n in ("fwd", "bwd"):
            f = fields.setdefault(f"attention_{n}_general", {"dtype":
                                                             "float32"})
            f.update({
                "ms" + tag: row[f"{n}_kernel_ms"],
                "device_ms" + tag: row[f"{n}_kernel_device_ms"],
                "plain_ms" + tag: row[f"{n}_plain_ms"],
                "library_ms" + tag: row[f"{n}_sdpa_ms"],
                "plain_device_ms" + tag: row[f"{n}_plain_device_ms"],
                "library_device_ms" + tag: row[f"{n}_sdpa_device_ms"],
                "bound_ms" + tag: row[f"{n}_bound_ms"]})
            if not tag:
                f["bound_by"] = row[f"{n}_bound_by"]
    return rows, fields


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
    counts = by_body(A)
    (lc, dc, gc), (lg, dg, gg) = res["cpu"], res["cuda"]
    # fp32 on both devices; 12 blocks of other summation orders
    e_logits = rel_err(lg, lc)[1]
    e_grads = rel_err(gg, gc)[1]
    log(f"reference DeiT-S fp32 card vs CPU: logits rel {e_logits:.3e}, "
        f"decoder loss {dg:.6f} vs {dc:.6f}, grads rel {e_grads:.3e}")
    if not (e_logits < 1e-3 and abs(dg - dc) <= 1e-4 * abs(dc)
            and e_grads < 1e-3 and math.isfinite(dg)):
        raise AssertionError("the port on the card disagrees with the CPU")
    if counts != only("general", 12, 12):
        raise AssertionError(f"fp32 launches by body {counts}, expected "
                             f"12 general each")
    log(f"reference: launches by body {counts}")
    return kernel_counts(counts)


# a subnet whose head dims are not multiples of 8 (4, 6, 12, 36), as a
# `--tiny-test` search exports them, at DeiT-S's width and token count; depth
# cut to its four blocks
SMALL_HEADS_CFG = dict(img_size=224, patch_size=16, num_classes=1000,
                       embed_dim=384, depth=4, num_heads=6, drop_path_rate=0.0,
                       block_overrides=((6, 4, 1536), (6, 6, 1536),
                                        (6, 12, 1536), (6, 36, 1536)))


def check_small_heads(A, steps=2, batch=8):
    """Phase 4, continued: that subnet's dense train steps (layer-decay
    AdamW, label smoothing) and an eval step on the card, fp32, against the
    same steps on the CPU from the same weights and images, within phase
    4's tolerances (losses rel 1e-4, parameters after the steps and the
    eval loss rel 1e-3); the card's launches, counted from 0, all on the
    general body: per block one forward and one backward a train step, one
    forward for the eval step. Returns those launches."""
    import copy
    import torch
    from ofb_tpu_torch.core import lr_decay as LD
    from ofb_tpu_torch.core import steps as S
    from ofb_tpu_torch.models.vit import ModelCfg, ViT

    cfg = ModelCfg(**SMALL_HEADS_CFG)
    g = torch.Generator().manual_seed(16)
    model = ViT(cfg, generator=g)
    images = torch.rand((steps + 1, 1, batch, 224, 224, 3), generator=g)
    labels = torch.randint(0, 1000, (steps + 1, 1, batch), generator=g)
    res = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        tx = LD.build_finetune_optimizer(
            m, lr_schedule=lambda c: 1e-4, betas=(0.9, 0.95),
            weight_decay=0.05, layer_decay=0.75, num_layers=cfg.depth)
        state = S.TrainState(0, m, None, None,
                             tx.init(dict(m.named_parameters())))
        step = S.make_train_step(cfg, tx, num_classes=1000, smoothing=0.1,
                                 compute_dtype=torch.float32, device=dev)
        A.reset_launch_counts()
        losses = []
        for k in range(steps):
            state, met = step(state, images[k], labels[k])
            losses.append(met["loss"].item())
        ev = S.make_eval_step_dense(cfg, compute_dtype=torch.float32,
                                    device=dev)(state.params, images[steps, 0],
                                                labels[steps, 0])
        res[dev] = (losses, torch.cat([p.detach().flatten().cpu() for p in
                                       state.params.parameters()]),
                    ev["loss_sum"].item(), by_body(A))
    (lc, pc, ec, _), (lg, pg, eg, counts) = res["cpu"], res["cuda"]
    e_params = rel_err(pg, pc)[1]
    log(f"small heads {[b[1] for b in cfg.block_overrides]} fp32 card vs "
        f"CPU: train losses {lg} vs {lc}, params rel {e_params:.3e}, eval "
        f"loss {eg:.6f} vs {ec:.6f}; launches by body {counts}")
    if not (all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lg, lc))
            and e_params < 1e-3 and abs(eg - ec) <= 1e-3 * abs(ec)
            and math.isfinite(eg)):
        raise AssertionError("the small-heads subnet on the card disagrees "
                             "with the CPU")
    want = only("general", cfg.depth * (steps + 1), cfg.depth * steps)
    if counts != want:
        raise AssertionError(f"small heads: launches by body {counts}, "
                             f"expected {want}")
    return kernel_counts(counts)


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
    counts = by_body(A)

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
    if counts != only("resident", want, want):
        raise AssertionError(f"the slice did not run the resident body "
                             f"throughout: {counts}")
    img_s = batch * steps / dt
    log(f"slice: DeiT-S search step, batch {batch}, bf16: {img_s:.2f} img/s "
        f"({dt / steps * 1e3:.2f} ms/step over {steps} steps); launches "
        f"{launches}, all through the resident body")
    return kernel_counts(counts)


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
    totals = only("resident", 0, 0)

    def take_counts():
        """The launches since the last reset, by body; adds them to the
        phase's totals and sets the counts to 0."""
        got = by_body(A)
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
    blocks = dict.fromkeys(BODIES, 0)
    for _, d, _ in dcfg.block_overrides:
        blocks[A.attention_body(N, d, torch.bfloat16).name] += 1
    micro = steps + 1
    per_body = {b: n * micro for b, n in blocks.items()}
    want_train = {"attention_fwd": per_body, "attention_bwd": per_body}
    want_eval = {"attention_fwd": per_body,
                 "attention_bwd": dict.fromkeys(BODIES, 0)}
    if got_train != want_train or got_eval != want_eval:
        raise AssertionError(
            f"subnet launches by body: train {got_train} (expected "
            f"{want_train}), eval {got_eval} (expected {want_eval})")
    odd = [d for _, d, _ in dcfg.block_overrides if d % 16]
    if blocks != only("resident", cfg.depth, 0)["attention_fwd"] or not odd \
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
    return kernel_counts(totals)


# log.txt keys of the JAX package's scripts/search.py: a search epoch and a
# postsearch epoch (the step's metrics, the epoch's time and rate, the soft
# accuracy, the epoch and the searched size)
_TAIL = {"train_epoch_time_s", "train_img_s", "soft_test_loss",
         "soft_test_acc1", "soft_test_acc5", "epoch", "n_parameters",
         "n_gflops"}
LOG_KEYS_SEARCH = _TAIL | {f"train_{k}" for k in (
    "loss_param", "loss_total", "loss_arch", "loss_decoder",
    "searched_gflops", "grad_norm")}
LOG_KEYS_POSTSEARCH = _TAIL | {f"train_{k}" for k in (
    "loss_param", "loss_total", "grad_norm")}


def run_cli(A, module, argv):
    """One CLI run in this process through its own parser and `main`, its
    attention launches counted from 0. Returns (main's result, the printed
    text, launches by kernel and body, seconds)."""
    import torch
    from ofb_tpu_torch.cli.common import run_main
    A.reset_launch_counts()
    t0 = time.perf_counter()
    out, text = run_main(module, argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = by_body(A)
    A.reset_launch_counts()
    return out, text, counts, dt


def _epochs(text):
    """(epoch, img/s, feed, dispatch, readback, compress seconds) of every
    epoch line a CLI printed."""
    from ofb_tpu_torch.core.engine import epoch_lines
    return [tuple(e.values()) for e in epoch_lines(text)]


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.startswith("{")]


def _expect_counts(got, fwd, bwd, where, body="resident"):
    """All launches through one body, as `attention_body` picks it for
    every bf16 shape of a run: the resident body at N <= 197 (phase 7),
    the streaming one at 577 (phase 8); d a multiple of 8."""
    want = only(body, fwd, bwd)
    if got != want:
        raise AssertionError(f"{where}: attention launches {got}, expected "
                             f"{want}")


def run_clis(A, card, root):
    """Phase 7: the port's CLIs, in process, DeiT-S at full width and depth:
    search (SYNTHETIC 1024, staging 256 -> 224, batch 64, bf16, fused
    RandAugment m9 + erasing 0.25, Mixup 0.8 / CutMix 1.0 after the finish,
    compress threshold 1.0, 4 epochs), a resumed fifth epoch, export of the
    best checkpoint into `root`/exported, one finetune epoch of the subnet
    (EMA, device cache) and the eval CLI on its best. Returns the launches
    of the five runs."""
    import torch
    from ofb_tpu_torch.cli import eval as eval_cli
    from ofb_tpu_torch.cli import export, finetune, search
    from ofb_tpu_torch.ops import augment as AUG

    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)

    def add(counts):
        for k, n in kernel_counts(counts).items():
            totals[k] += n

    sdir = os.path.join(root, "search")
    common = ["--data-set", "SYNTHETIC", "--batch-size", "64",
              "--output_dir", sdir]
    search_argv = common + [
        "--model", "deit_small_patch16_224_mim", "--synthetic-size",
        "1024", "--accum-iter", "1", "--mixup", "0.8", "--cutmix", "1.0",
        "--compress-thresh", "1.0"]
    steps, n_val = 1024 // 64, 1024 // 64

    # 7.1 search: search epochs, the finish, postsearch epochs, fuse
    _, text, counts, dt = run_cli(A, search,
                                  search_argv + ["--epochs", "4"])
    add(counts)
    slog = _log(os.path.join(sdir, "log.txt"))
    if "== finish_search" not in text or "saved model_fused" not in text:
        raise AssertionError("the search did not finish and fuse")
    for name in ("running_ckpt", "best", "model_fused", "log.txt",
                 "alpha.txt"):
        if not os.path.exists(os.path.join(sdir, name)):
            raise AssertionError(f"the search wrote no {name}")
    kinds = []
    for row in slog:
        keys = set(row)
        kinds.append("search" if keys == LOG_KEYS_SEARCH else
                     "postsearch" if keys == LOG_KEYS_POSTSEARCH else
                     None)
        if kinds[-1] is None:
            raise AssertionError(f"log.txt keys {sorted(keys)} are not "
                                 "the JAX CLI's")
        if not all(math.isfinite(v) for k, v in row.items()
                   if k.startswith("train_loss")):
            raise AssertionError(f"a loss is not finite: {row}")
    if "search" not in kinds or "postsearch" not in kinds:
        raise AssertionError(f"epochs by phase {kinds}: wanted a search "
                             "and a postsearch epoch")
    fused = json.load(open(os.path.join(sdir, "model_fused",
                                        "meta.json")))
    if not 0.0 <= fused["fused_acc1"] <= 100.0:
        raise AssertionError(f"fused accuracy {fused['fused_acc1']}")
    _expect_counts(counts, 12 * (4 * steps + 5 * n_val), 12 * 4 * steps,
                   "search")
    passes = [float(x) * 1e3 for x in re.findall(
        r"compress pass ([\d.]+)s", text)]
    ep = _epochs(text)
    RATES["search"] = [round(e[1], 1) for e in ep]
    log(f"cli search: {len(ep)} epochs ({', '.join(kinds)}) in {dt:.1f} "
        f"s; sustained img/s by epoch (log.txt train_img_s) "
        f"{[round(r['train_img_s'], 2) for r in slog]}; split of each "
        f"epoch, s (feed, dispatch, readback, compress): "
        f"{[e[2:] for e in ep]}; {len(passes)} compress passes, host ms "
        f"{[round(p, 2) for p in passes]}; fused acc1 "
        f"{fused['fused_acc1']:.3f}; launches {counts}; on {card}")

    # 7.2 resume at the next epoch
    _, text, counts, dt = run_cli(A, search, search_argv + [
        "--epochs", "5", "--resume", "--checkpoint",
        os.path.join(sdir, "running_ckpt")])
    add(counts)
    ep = _epochs(text)
    if "resumed from" not in text or [e[0] for e in ep] != [4]:
        raise AssertionError(f"the resumed search ran epochs "
                             f"{[e[0] for e in ep]}, wanted [4]")
    _expect_counts(counts, 12 * (steps + 2 * n_val), 12 * steps,
                   "resumed search")
    log(f"cli resume: epoch 4 at {ep[0][1]:.2f} img/s, split "
        f"{ep[0][2:]}; launches {counts}")

    # 7.3 export of the best checkpoint
    xdir = os.path.join(root, "exported")
    (dense, dcfg), text, counts, dt = run_cli(A, export, [
        "--checkpoint", os.path.join(sdir, "best"), "--out", xdir])
    add(counts)
    N = dcfg.num_patches + dcfg.num_tokens
    bodies = {A.attention_body(N, d, torch.bfloat16).name
              for _, d, _ in dcfg.block_overrides}
    if bodies != {"resident"}:
        raise AssertionError(f"subnet blocks take bodies {bodies}")
    log(f"cli export: D {dcfg.embed_dim}, blocks (heads, head dim, mlp) "
        f"{list(dcfg.block_overrides)} in {dt:.1f} s")

    # 7.4 one finetune epoch, EMA, device cache
    fdir = os.path.join(root, "finetune")
    ft_steps, ft_val = 2048 // 64, 2048 // 64
    fstate, text, counts, dt = run_cli(A, finetune, [
        "--data-set", "SYNTHETIC", "--batch-size", "64", "--finetune",
        xdir, "--epochs", "1", "--model-ema", "--cache-device",
        "--output_dir", fdir])
    add(counts)
    flog = _log(os.path.join(fdir, "log.txt"))
    if not (math.isfinite(flog[-1]["train_loss"])
            and os.path.exists(os.path.join(fdir, "best", "meta.json"))):
        raise AssertionError(f"finetune: {flog}")
    _expect_counts(counts, 12 * (ft_steps + 2 * ft_val), 12 * ft_steps,
                   "finetune")
    ep = _epochs(text)
    RATES["finetune"] = round(ep[0][1], 1)
    log(f"cli finetune: {ep[0][1]:.2f} img/s sustained (log.txt "
        f"{flog[-1]['train_img_s']:.2f}), split {ep[0][2:]}, loss "
        f"{flog[-1]['train_loss']:.4f}, acc1 raw "
        f"{flog[-1]['soft_test_acc1']:.3f} ema "
        f"{flog[-1]['soft_test_ema_acc1']:.3f}; launches {counts}")

    # 7.5 eval of the finetune's best
    stats, text, counts, dt = run_cli(A, eval_cli, [
        "--checkpoint", os.path.join(fdir, "best"), "--data-set",
        "SYNTHETIC", "--batch-size", "64"])
    add(counts)
    if not (0.0 <= stats["acc1"] <= 100.0
            and math.isfinite(stats["loss"])):
        raise AssertionError(f"eval: {stats}")
    _expect_counts(counts, 12 * 2048 // 64, 0, "eval")
    log(f"cli eval: {stats} in {dt:.1f} s; launches {counts}")

    # the train transform at batch 256 (staging 256 -> 224), device time,
    # next to the search step at batch 256
    from ofb_tpu_torch.bench import augment_call, build_step
    aug_ms = device_time_ms(augment_call(256), iters=5)
    g = torch.Generator(device="cuda").manual_seed(7)
    draw_ms = device_time_ms(lambda: AUG.draw_train_augment(
        g, 256, 256, 224, device="cuda"), iters=5)
    bundle, state, step, images, labels = build_step("deit_small", 256)
    box = {"state": state}

    def search_call():
        box["state"], m = step(box["state"], images, labels, g, 0.75)
        return m
    step_ms = device_time_ms(search_call, iters=3, warmup=2)
    log(f"augment on {card}: apply_train_augment at batch 256 (256 -> 224, "
        f"RandAugment m9 2 layers, erasing) {aug_ms:.3f} ms device time, its "
        f"draws {draw_ms:.3f} ms; the search step at batch 256 "
        f"{step_ms:.3f} ms device time")
    return totals


def run_384(A, card, root):
    """Phase 8: the 384-pixel path through the CLIs, in process, bf16,
    batch 64, SYNTHETIC at staging 256 -> 384 (577 tokens): `cli.finetune
    --model deit_small_patch16_384 --input-size 384 --from-scratch` for one
    epoch (device cache, EMA) and `cli.eval` of its best; then phase 7's
    exported subnet (`root`/exported, searched at 224) finetuned one epoch
    at --input-size 384, its pos-embed resized 197 -> 577, and evaluated.
    Every attention launch of the four runs must take the streaming body.
    Returns the launches of the four runs."""
    import torch
    from ofb_tpu_torch.cli import eval as eval_cli
    from ofb_tpu_torch.cli import finetune
    from ofb_tpu_torch.core import checkpoint as ckpt
    from ofb_tpu_torch.models.vit import ModelCfg

    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)
    steps = n_val = 2048 // 64           # SYNTHETIC's train and val sets
    runs = (("DeiT-S-384 from scratch",
             ["--model", "deit_small_patch16_384", "--from-scratch"]),
            ("phase 7's exported subnet",
             ["--finetune", os.path.join(root, "exported")]))
    for i, (what, argv) in enumerate(runs):
        fdir = os.path.join(root, f"finetune_384_{i}")
        _, text, counts, dt = run_cli(A, finetune, argv + [
            "--data-set", "SYNTHETIC", "--batch-size", "64", "--input-size",
            "384", "--epochs", "1", "--model-ema", "--cache-device",
            "--output_dir", fdir])
        meta = json.load(open(os.path.join(fdir, "best", "meta.json")))
        cfg = ckpt.model_cfg_from_meta(meta["model_cfg"], ModelCfg)
        N = cfg.num_patches + cfg.num_tokens
        dims = sorted({cfg.block_dims(b)[1] for b in range(cfg.depth)})
        bodies = {A.attention_body(N, d, torch.bfloat16).name for d in dims}
        if (cfg.img_size, N) != (384, 577) or bodies != {"streaming"}:
            raise AssertionError(f"{what}: img_size {cfg.img_size}, {N} "
                                 f"tokens, head dims {dims} on {bodies}")
        flog = _log(os.path.join(fdir, "log.txt"))
        if not math.isfinite(flog[-1]["train_loss"]):
            raise AssertionError(f"finetune at 384 ({what}): {flog}")
        _expect_counts(counts, cfg.depth * (steps + 2 * n_val),
                       cfg.depth * steps, f"finetune at 384 ({what})",
                       "streaming")
        for k, n in kernel_counts(counts).items():
            totals[k] += n
        ep = _epochs(text)
        log(f"cli finetune at 384, {what}: D {cfg.embed_dim}, head dims "
            f"{dims}, {N} tokens; {ep[0][1]:.2f} img/s sustained (log.txt "
            f"{flog[-1]['train_img_s']:.2f}), split {ep[0][2:]}, loss "
            f"{flog[-1]['train_loss']:.4f}, acc1 raw "
            f"{flog[-1]['soft_test_acc1']:.3f} ema "
            f"{flog[-1]['soft_test_ema_acc1']:.3f} in {dt:.1f} s; launches "
            f"{counts}; on {card}")

        stats, text, counts, dt = run_cli(A, eval_cli, [
            "--checkpoint", os.path.join(fdir, "best"), "--data-set",
            "SYNTHETIC", "--batch-size", "64"])
        if not (0.0 <= stats["acc1"] <= 100.0
                and math.isfinite(stats["loss"])):
            raise AssertionError(f"eval at 384 ({what}): {stats}")
        _expect_counts(counts, cfg.depth * n_val, 0,
                       f"eval at 384 ({what})", "streaming")
        for k, n in kernel_counts(counts).items():
            totals[k] += n
        log(f"cli eval at 384, {what}: {stats} in {dt:.1f} s; launches "
            f"{counts}")
    return totals


def graph_vs_eager(what, pstep, state, batch, search, K=3):
    """K + 2 calls of a planned step from copies of `state` over one device
    cache and plan, the generator at one seed: eagerly through the step's
    own function, and through the `PlannedStep` (two eager warm-up calls,
    the capture, then replays). The ArchState must be bit-identical, the
    packed outputs and every other tensor of the state within TOL_GRAPH of
    the leaf's largest magnitude. Returns (the graph run's `PlannedCalls`,
    the largest difference)."""
    import copy
    import torch
    from ofb_tpu_torch.bench import PlannedCalls
    from ofb_tpu_torch.core.steps import named_tensors

    runs = {}
    for kind in ("eager", "graph"):
        box = {"state": copy.deepcopy(state)}
        calls = PlannedCalls(pstep, box, batch, K + 6, search=search,
                             images=256, seed=9)
        outs = []
        for _ in range(K + 2):
            getattr(calls, kind)()
            outs.append(calls.out.detach().float().reshape(-1).clone())
        torch.cuda.synchronize()
        runs[kind] = (box["state"], outs, calls)
    (es, eo, _), (gs, go, calls) = runs["eager"], runs["graph"]
    if pstep.captures != 1 or pstep.replays != K:
        raise AssertionError(f"{what}: {pstep.captures} captures, "
                             f"{pstep.replays} replays; wanted 1 and {K}")
    worst, n_leaves = ("", 0.0), 0
    pairs = [(f"output {i}", a, b) for i, (a, b) in enumerate(zip(go, eo))]
    pairs += [(n, a, b) for (n, a), (_, b) in zip(named_tensors(gs),
                                                  named_tensors(es))]
    for n, a, b in pairs:
        n_leaves += 1
        if n.startswith("arch.") or n == "step" or not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {n} differs between the "
                                     "graph replays and the eager runs")
            continue
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: {n} is not finite")
        d = ((a.float() - b.float()).abs().max()
             / b.float().abs().max().clamp_min(1e-30)).item()
        if d > worst[1]:
            worst = (n, d)
    if worst[1] > TOL_GRAPH:
        raise AssertionError(f"{what}: graph replays and eager runs differ "
                             f"at {worst[0]} by {worst[1]:.3e}")
    log(f"planned {what}: {K + 2} calls (2 eager warm-up, the capture, {K} "
        f"replays) against {K + 2} eager calls: ArchState bit-identical, "
        f"{n_leaves} tensors compared, largest difference {worst[1]:.3e} "
        f"({worst[0] or 'none'}; tol {TOL_GRAPH:g}); outputs "
        f"{[round(x, 5) for x in go[-1].tolist()[:3]]}")
    return calls, worst[1]


def trace_replay(A, what, calls, tries=4):
    """A torch.profiler trace of one replay: the resident attention kernels
    in it (forward; the fused backward or the dq kernel of a dq + dk/dv
    pair), against the counters a replay adds. Wants 12 + 12 (one
    microbatch), no other attention body. Retakes a session that lost
    kernel records. Returns the trace's (forward, backward) counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(tries):
        calls.restart()
        torch.cuda.synchronize()
        A.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            calls.graph()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        fwd = sum("attention_fwd_resident_kernel" in n for n in names)
        bwd = sum("attention_bwd_fused_kernel" in n
                  or "attention_bwd_dq_resident_kernel" in n for n in names)
        other = sorted({n.split("(")[0] for n in names if "attention_" in n
                        and "resident" not in n and "fused" not in n})
        seen.append((len(names), fwd, bwd))
        if (fwd, bwd) == (12, 12):
            break
    counters = by_body(A)
    A.reset_launch_counts()
    if (fwd, bwd) != (12, 12) or other:
        raise AssertionError(f"{what}: traces of one replay counted "
                             f"(kernels, resident forward, backward) {seen}, "
                             f"other attention kernels {other}; wanted 12 + "
                             "12 resident")
    if counters != only("resident", 12, 12):
        raise AssertionError(f"{what}: the counters after one replay "
                             f"{counters} disagree with the trace (12 + 12)")
    log(f"planned {what}: a profiler trace of one replay holds {len(names)} "
        f"kernels, 12 + 12 of them the resident attention body (the "
        f"counters after the replay: {counters['attention_fwd']['resident']}"
        f" + {counters['attention_bwd']['resident']}); sessions {seen}")
    return fwd, bwd


def _graph_lines(text):
    """(captures, replays, calls) of the engine's `planned step:` lines."""
    return [tuple(int(x) for x in m) for m in re.findall(
        r"planned step: (\d+) CUDA graph capture, (\d+) replays of (\d+) "
        r"calls", text)]


def run_planned(A, card, root):
    """Phase 9: the planned path, DeiT-S at full width and depth, bf16,
    batch 64 (see the module docstring). Returns the launches counted over
    the whole phase, replays included."""
    import torch
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.cli import finetune, search
    from ofb_tpu_torch.core.steps import make_planned_search_step
    from ofb_tpu_torch.models.registry import create_model
    from ofb_tpu_torch.models.torch_import import params_to_torch_state_dict

    batch = 64
    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)

    def add(counts):
        for k, n in kernel_counts(counts).items():
            totals[k] += n

    # 9.1 graph against eager: search, postsearch, the subnet's train step
    A.reset_launch_counts()
    bundle, state, _, _, _ = B.build_step("deit_small", batch, seed=8)
    scfg, tx = B.search_config(batch)
    worst = []
    pstep, _ = make_planned_search_step(
        bundle.space, bundle.cfg, scfg, tx, phase="search",
        steps_per_epoch=9, device="cuda")
    calls, d = graph_vs_eager("search step", pstep, state, batch, True)
    worst.append(d)
    add(by_body(A))
    trace_replay(A, "search step", calls)
    state = calls.box["state"]
    report, _, _ = B.force_convergence(state, bundle.space)
    if not report.finish_search:
        raise AssertionError(f"the forced convergence: {report.events}")
    pstep, _ = make_planned_search_step(
        bundle.space, bundle.cfg, scfg, tx, phase="postsearch",
        steps_per_epoch=9, device="cuda")
    A.reset_launch_counts()
    calls, d = graph_vs_eager("postsearch step", pstep, state, batch, True)
    worst.append(d)
    _, dcfg, _, fstate, train, _ = B.build_subnet_steps(
        bundle, calls.box["state"], batch, planned=True)
    calls, d = graph_vs_eager("train step of the exported subnet", train,
                              fstate, batch, False)
    worst.append(d)
    add(by_body(A))
    trace_replay(A, "subnet train step", calls)
    del calls, pstep, train, state, fstate
    torch.cuda.empty_cache()

    # 9.2 the planned CLIs
    sdir = os.path.join(root, "planned_search")
    steps = n_val = 512 // 64
    argv = ["--data-set", "SYNTHETIC", "--batch-size", "64", "--model",
            "deit_small_patch16_224_mim", "--synthetic-size", "512",
            "--accum-iter", "1", "--mixup", "0.8", "--cutmix", "1.0",
            "--compress-thresh", "1.0", "--cache-device", "--planned-epoch"]
    _, text, counts, dt = run_cli(A, search, argv + [
        "--epochs", "4", "--output_dir", sdir])
    add(counts)
    slog = _log(os.path.join(sdir, "log.txt"))
    kinds = ["search" if set(r) == LOG_KEYS_SEARCH else "postsearch"
             if set(r) == LOG_KEYS_POSTSEARCH else None for r in slog]
    graphs = _graph_lines(text)
    if "== finish_search" not in text or "saved model_fused" not in text \
            or kinds.count("postsearch") < 1 or None in kinds:
        raise AssertionError(f"the planned search: epochs by phase {kinds}")
    if len(graphs) != 4 or any(c != 1 or r < 1 for c, r, _ in graphs):
        raise AssertionError(f"the planned search's graph lines {graphs}")
    if not all(math.isfinite(v) for r in slog for k, v in r.items()
               if k.startswith("train_loss")):
        raise AssertionError(f"the planned search: a loss is not finite")
    _expect_counts(counts, 12 * (4 * steps + 5 * n_val), 12 * 4 * steps,
                   "planned search")
    ep = _epochs(text)
    log(f"planned cli search ({', '.join(kinds)}; SYNTHETIC 512) on {card}: "
        f"img/s by epoch {[round(e[1], 1) for e in ep]} (phase 7's classic "
        f"search, SYNTHETIC 1024 from the host loader: {RATES.get('search')})"
        f"; split (feed, dispatch, readback, compress) {[e[2:] for e in ep]}"
        f"; (captures, replays, calls) by epoch {graphs}; launches {counts} "
        f"in {dt:.1f} s")

    fdir = os.path.join(root, "planned_finetune")
    ft_steps, ft_val = 2048 // 64, 2048 // 64
    _, text, counts, dt = run_cli(A, finetune, [
        "--data-set", "SYNTHETIC", "--batch-size", "64", "--finetune",
        os.path.join(root, "exported"), "--epochs", "1", "--model-ema",
        "--cache-device", "--planned-epoch", "--distillation-type", "hard",
        "--teacher-model", "regnety_160", "--output_dir", fdir])
    add(counts)
    flog = _log(os.path.join(fdir, "log.txt"))
    graphs = _graph_lines(text)
    if not math.isfinite(flog[-1]["train_loss"]) or len(graphs) != 1 \
            or graphs[0][:2] != (1, ft_steps - 2):
        raise AssertionError(f"the planned finetune: {flog}, graph lines "
                             f"{graphs}")
    _expect_counts(counts, 12 * (ft_steps + 2 * ft_val), 12 * ft_steps,
                   "planned finetune")
    ep = _epochs(text)
    log(f"planned cli finetune with a RegNetY-160 teacher (hard) on {card}: "
        f"{ep[0][1]:.2f} img/s sustained (phase 7's classic cached "
        f"finetune without a teacher: {RATES.get('finetune')}), split "
        f"{ep[0][2:]}, loss {flog[-1]['train_loss']:.4f}; (captures, "
        f"replays, calls) {graphs}; launches {counts} in {dt:.1f} s")

    pdir = os.path.join(root, "pretrained")
    os.makedirs(pdir)
    deit = create_model("deit_small_patch16_224", device="cuda").init(12)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          params_to_torch_state_dict(deit).items()}},
               os.path.join(pdir, "deit_s.pth"))
    del deit
    _, text, counts, dt = run_cli(A, search, [
        "--data-set", "SYNTHETIC", "--batch-size", "64", "--model",
        "deit_small_patch16_224_mim", "--synthetic-size", "256",
        "--cache-device", "--planned-epoch", "--epochs", "1",
        "--pretrained_path", os.path.join(pdir, "deit_s.pth"),
        "--output_dir", os.path.join(pdir, "run")])
    add(counts)
    plog = _log(os.path.join(pdir, "run", "log.txt"))
    if "loaded pretrained weights" not in text \
            or not math.isfinite(plog[-1]["train_loss_total"]):
        raise AssertionError(f"the pretrained search: {plog}")
    _expect_counts(counts, 12 * (4 + 4), 12 * 4, "pretrained search")
    log(f"planned cli search from a DeiT-S state dict: "
        f"{_epochs(text)[0][1]:.2f} img/s, loss "
        f"{plog[-1]['train_loss_total']:.4f}; launches {counts}")
    log(f"planned path: largest graph-vs-eager difference "
        f"{max(worst):.3e}; launches {totals}")
    return totals


# the TPU searches committed in runs/ (their params are not committed) and
# the finetunes of the two DeiT-S ones, whose meta records the subnet
TPU_RUNS = (("runs/organic_a8", "runs/organic_a8/torganic/ft/best"),
            ("runs/ladder_organic/t0.45", "runs/ladder_organic/t0.45/ft/best"),
            ("runs/ladder_organic_b/t0.4964", None))
# phase 10's timed calls of each TPU subnet's train and eval steps
SUBNET_CALLS = 4
# phase 10's CLI runs: SYNTHETIC's train and val sets, each
VIT_IMAGES = 1024
# phase 10's CLI runs: (registry name, input size, batch, the body that
# serves its bf16 attention)
VIT_CLI = (("vit_base_patch16_224", 224, 64, "resident"),
           ("vit_large_patch16_384", 384, 32, "streaming"),
           ("vit_huge_patch14_224", 224, 32, "streaming"))
# phase 10's single eval batches, and the fp32 card-vs-CPU comparisons
VIT_EVAL = ("vit_base_patch16_224_in21k", "vit_base_patch16_224_miil",
            "vit_small_patch16_224")


def _add(totals, counts):
    for k, n in kernel_counts(counts).items():
        totals[k] = totals.get(k, 0) + n


def run_tpu_searches(A, card, totals):
    """Phase 10 (a): the JAX package's TPU search results, read from their
    msgpack files with the port's reader (alphas and arch state; asking for
    the params, listed but not committed, must raise), force-finished from
    seeded weights, exported, and the subnet's train and eval steps each
    called once to warm up and SUBNET_CALLS times timed, batch 64, bf16;
    the two DeiT-S runs must export to the subnets their TPU finetunes
    recorded. Then the dense model of one of
    those finetunes' meta, one eval batch."""
    import torch
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.core import checkpoint as ckpt
    from ofb_tpu_torch.core.compress import compress
    from ofb_tpu_torch.core.export import export_subnet
    from ofb_tpu_torch.core.steps import make_eval_step_dense
    from ofb_tpu_torch.models.registry import create_model
    from ofb_tpu_torch.models.vit import ModelCfg, ViT

    here = os.path.dirname(os.path.abspath(__file__))
    batch = 64
    for run, ft in TPU_RUNS:
        best = os.path.join(here, run, "best")
        meta = ckpt.latest_meta(best)
        bundle = create_model(meta["args"]["model"], device="cuda")
        params, alphas, arch = bundle.init(0)
        try:
            ckpt.load_checkpoint(best, params=params)
        except FileNotFoundError:
            pass
        else:
            raise AssertionError(f"{run}: its params are not committed, yet "
                                 "reading them did not raise")
        ckpt.load_checkpoint(best, alphas=alphas, arch=arch)
        passes = 0
        while not arch.all_finished and passes < 20:
            params, alphas, arch, _, _ = compress(params, alphas, arch, None,
                                                  bundle.space, thresh=1.0)
            passes += 1
        dense, dcfg, _ = export_subnet(params, arch, bundle.space, bundle.cfg,
                                       fuse=True)
        del params
        dims = [list(b) for b in dcfg.block_overrides]
        if ft is not None:
            want = ckpt.latest_meta(os.path.join(here, ft))["model_cfg"]
            if (dcfg.embed_dim, dims) != (want["embed_dim"],
                                          want["block_overrides"]):
                raise AssertionError(
                    f"{run} exported D {dcfg.embed_dim}, {dims}; its TPU "
                    f"finetune recorded D {want['embed_dim']}, "
                    f"{want['block_overrides']}")
        _, _, _, fstate, train, evaluate = B.build_subnet_steps(
            bundle, None, batch, subnet=(dense, dcfg))
        images, labels = B.random_batch(dcfg, batch, "cuda", seed=13)
        gen = torch.Generator(device="cuda").manual_seed(13)
        A.reset_launch_counts()
        rates = {}
        for kind in ("train", "eval"):
            # one warm-up call, then SUBNET_CALLS timed back to back
            for i in range(1 + SUBNET_CALLS):
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                if kind == "train":
                    fstate, m = train(fstate, images, labels, gen)
                else:
                    m = evaluate(dense, images[0], labels[0])
            torch.cuda.synchronize()
            rates[kind] = round(SUBNET_CALLS * batch
                                / (time.perf_counter() - t0), 2)
            m = _finite(m, f"{run} subnet {kind} step")
            if kind == "train":
                loss = m["loss"]
                got_train = by_body(A)
        counts = by_body(A)
        _add(totals, counts)
        calls = 1 + SUBNET_CALLS
        _expect_counts(got_train, calls * dcfg.depth, calls * dcfg.depth,
                       f"{run} subnet train steps")
        _expect_counts(counts, 2 * calls * dcfg.depth, calls * dcfg.depth,
                       f"{run} subnet train and eval steps")
        log(f"tpu search {run} ({meta['args']['model']}): {passes} compress "
            f"passes to finish; exported D {dcfg.embed_dim}, blocks (heads, "
            f"head dim, mlp) {dims}"
            + ("" if ft is None else ", equal to its TPU finetune's meta")
            + f"; on {card}, batch {batch}, bf16, img/s over {SUBNET_CALLS} "
            f"calls after one warm-up: train {rates['train']} (loss "
            f"{loss:.4f}), eval {rates['eval']}; launches {counts}")
        del dense, fstate, train, evaluate
        torch.cuda.empty_cache()

    cfg = ckpt.model_cfg_from_meta(ckpt.latest_meta(os.path.join(
        here, TPU_RUNS[0][1]))["model_cfg"], ModelCfg)
    model = ViT(cfg, generator=torch.Generator().manual_seed(14)).to("cuda")
    images, labels = B.random_batch(cfg, batch, "cuda", seed=14)
    A.reset_launch_counts()
    ev = _finite(make_eval_step_dense(cfg)(model, images[0], labels[0]),
                 "the TPU finetune's model")
    counts = by_body(A)
    _add(totals, counts)
    _expect_counts(counts, cfg.depth, 0, "the TPU finetune's model")
    log(f"tpu finetune meta {TPU_RUNS[0][1]}: the dense model of its "
        f"model_cfg (D {cfg.embed_dim}), one eval batch of {batch}: loss "
        f"{ev['loss_sum'] / batch:.4f}; launches {counts}")


def run_vit_family(A, card, root):
    """Phase 10: (a) `run_tpu_searches`; (b) the ViT family through the
    CLIs, in process, bf16, SYNTHETIC VIT_IMAGES at staging 256:
    `cli.finetune --from-scratch --cache-device` one epoch and `cli.eval` of
    its best for each of VIT_CLI, then one eval batch of each of VIT_EVAL
    and its fp32 logits and gradients on the card against the CPU's at 2
    images. Every bf16 run's attention launches, counted from 0, on the
    body VIT_SHAPES names, none on the general body. Returns the launches
    of the bf16 runs and, apart, of the fp32 comparisons (the general
    body's)."""
    import torch
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.cli import eval as eval_cli
    from ofb_tpu_torch.cli import finetune
    from ofb_tpu_torch.core.steps import make_eval_step_dense
    from ofb_tpu_torch.models.registry import create_model
    from ofb_tpu_torch.models.vit import vit_forward

    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)
    run_tpu_searches(A, card, totals)

    for name, size, batch, body in VIT_CLI:
        fdir = os.path.join(root, f"finetune_{name}")
        steps = n_val = VIT_IMAGES // batch  # SYNTHETIC's train and val sets
        state, text, counts, dt = run_cli(A, finetune, [
            "--model", name, "--from-scratch", "--data-set", "SYNTHETIC",
            "--synthetic-size", str(VIT_IMAGES),
            "--batch-size", str(batch), "--input-size", str(size),
            "--epochs", "1", "--no-model-ema", "--cache-device",
            "--output_dir", fdir])
        _add(totals, counts)
        cfg = create_model(name, device="cuda").cfg
        flog = _log(os.path.join(fdir, "log.txt"))
        if not math.isfinite(flog[-1]["train_loss"]):
            raise AssertionError(f"finetune of {name}: {flog}")
        _expect_counts(counts, cfg.depth * (steps + n_val),
                       cfg.depth * steps, f"finetune of {name}", body)
        ep = _epochs(text)
        log(f"cli finetune {name} from scratch (D {cfg.embed_dim}, depth "
            f"{cfg.depth}, {cfg.num_heads} x {cfg.hd} heads, "
            f"{cfg.num_patches + cfg.num_tokens} tokens, batch {batch}) on "
            f"{card}: {ep[0][1]:.2f} img/s sustained (log.txt "
            f"{flog[-1]['train_img_s']:.2f}), split {ep[0][2:]}, loss "
            f"{flog[-1]['train_loss']:.4f} in {dt:.1f} s; launches {counts}")
        del state
        stats, text, counts, dt = run_cli(A, eval_cli, [
            "--checkpoint", os.path.join(fdir, "best"), "--data-set",
            "SYNTHETIC", "--synthetic-size", str(VIT_IMAGES),
            "--batch-size", str(batch)])
        _add(totals, counts)
        if not (0.0 <= stats["acc1"] <= 100.0
                and math.isfinite(stats["loss"])):
            raise AssertionError(f"eval of {name}: {stats}")
        _expect_counts(counts, cfg.depth * n_val, 0, f"eval of {name}", body)
        log(f"cli eval {name}: {stats} in {dt:.1f} s; launches {counts}")
        shutil.rmtree(fdir, ignore_errors=True)
        torch.cuda.empty_cache()

    fp32 = dict.fromkeys(kernel_counts(only("general", 0, 0)), 0)
    g = torch.Generator().manual_seed(15)
    for name in VIT_EVAL:
        bundle = create_model(name, device="cuda")
        cfg = bundle.cfg
        model = bundle.init(15)
        images, labels = B.random_batch(cfg, 64, "cuda", seed=15)
        A.reset_launch_counts()
        ev = _finite(make_eval_step_dense(cfg)(model, images[0], labels[0]),
                     f"{name} eval batch")
        counts = by_body(A)
        _add(totals, counts)
        N = cfg.num_patches + cfg.num_tokens
        _expect_counts(counts, cfg.depth, 0, f"{name} eval batch",
                       A.attention_body(N, cfg.hd, torch.bfloat16).name)
        x = torch.rand((2, cfg.img_size, cfg.img_size, 3), generator=g)
        res = {}
        for dev in ("cpu", "cuda"):
            m = model.to(dev)
            m.zero_grad(set_to_none=True)
            A.reset_launch_counts()
            logits = vit_forward(m, x.to(dev), cfg,
                                 compute_dtype=torch.float32)
            (logits * torch.linspace(-1, 1, logits.shape[-1],
                                     device=dev)).sum().backward()
            if dev == "cuda":
                _add(fp32, by_body(A))
            res[dev] = (logits.detach().cpu(), torch.cat(
                [p.grad.flatten().cpu() for p in m.parameters()]))
        (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
        e_logits, e_grads = rel_err(lg, lc)[1], rel_err(gg, gc)[1]
        log(f"{name} (D {cfg.embed_dim}, {cfg.num_heads} x {cfg.hd}, "
            f"qkv bias {cfg.qkv_bias}, pre-logits "
            f"{cfg.representation_size}, {cfg.num_classes} classes): bf16 "
            f"eval batch of 64 loss {ev['loss_sum'] / 64:.4f}, "
            f"launches {counts}; fp32 card vs CPU at 2 images: logits rel "
            f"{e_logits:.3e}, grads rel {e_grads:.3e}")
        if not (e_logits < 1e-3 and e_grads < 1e-3):
            raise AssertionError(f"{name}: the card disagrees with the CPU")
        del model, m, res
        torch.cuda.empty_cache()
    log(f"vit family: launches of the bf16 runs {totals}; of the fp32 "
        f"comparisons {fp32}")
    if any(n for k, n in totals.items() if k.endswith("_general")):
        raise AssertionError(f"a bf16 run of phase 10 launched the general "
                             f"body: {totals}")
    return totals, fp32


# phase 11: the Swin family
SWIN_MODEL = "swin_tiny_patch4_window7_224_mim"
SWIN_BATCH = 64
SWIN_CALLS = 4
SWIN_IMAGES = 512
SWIN_RUNS = ("runs/ladder_swin_r5/t0.45", "runs/ladder_swin_r5/t0.70")
# fp32 gradients of the card against the CPU, as max |card - cpu| over the
# leaf's largest magnitude: sums over 12 blocks in other orders (TF32 off)
TOL_GRADS = 1e-3


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _timed_calls(call, n):
    """One warm-up call, then n timed back to back: (last result, s/call)."""
    import torch
    out = call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = call()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / n


def run_swin(A, card, root):
    """Phase 11: the Swin family, `SWIN_MODEL` (Swin-T: D 96, depths
    2-2-6-2, heads 3-6-12-24, window 7, 224 px) with per-stage widths at
    full width and depth: (a) the fp32 gated forward and backward on the
    card against the CPU at batch 2; (b) bf16 search steps at batch 64, a
    forced compress to convergence, postsearch steps, the export, gated ==
    fused == sliced in fp32, the subnet's train and eval steps; (c) the
    planned search step as a graph replay against eager; (d) in process
    through the CLIs: `cli.search_swin --embed_search --cache-device
    --planned-epoch --force-finish --export-finetune-epochs 1`, `cli.eval`
    of its best/ and model_exported, one epoch of `cli.train_swin_dense`;
    (e) the two TPU searches of runs/ladder_swin_r5 exported on the card
    to the widths their model_exported/meta.json records. Swin's window
    attention is plain PyTorch, as in the JAX package: no attention kernel
    of the port may launch. Returns the launches counted (all 0)."""
    import copy
    import torch
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.cli import eval as eval_cli
    from ofb_tpu_torch.cli import search_swin, train_swin_dense
    from ofb_tpu_torch.core import checkpoint as ckpt
    from ofb_tpu_torch.core.compress import compress
    from ofb_tpu_torch.core.swin_steps import (make_planned_swin_search_step,
                                               make_swin_search_step)
    from ofb_tpu_torch.models.registry import create_model
    from ofb_tpu_torch.models.swin import swin_forward
    from ofb_tpu_torch.models.swin_search import (export_swin_subnet,
                                                  fuse_swin_params,
                                                  swin_model_flops,
                                                  swin_search_forward)

    # every body of both wrappers, at 0
    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)

    def add(counts):
        for k, n in kernel_counts(counts).items():
            totals[k] += n
    A.reset_launch_counts()
    f32 = dict(compute_dtype=torch.float32)

    # (a) fp32 forward and backward, card against CPU
    cpu = create_model(SWIN_MODEL, device="cpu", embed_search=True)
    p0, a0, ar0 = cpu.init(21)
    g = torch.Generator().manual_seed(22)
    x = torch.rand((2, 224, 224, 3), generator=g)
    wl = torch.randn((2, 1000), generator=g)
    res = {}
    for dev in ("cpu", "cuda"):
        p, a = copy.deepcopy(p0).to(dev), copy.deepcopy(a0).to(dev)
        logits = swin_search_forward(p, a, ar0.to(dev), x.to(dev), cpu.cfg,
                                     cpu.space, **f32)
        (logits * wl.to(dev)).sum().backward()
        grads = {n: t.grad.detach().cpu() for m in (p, a)
                 for n, t in m.named_parameters() if t.grad is not None}
        res[dev] = (logits.detach().cpu(), grads)
    d_logits = _rel(res["cuda"][0], res["cpu"][0])
    d_grads = max((_rel(res["cuda"][1][n], g) if g.abs().max() > 0 else 0.0,
                   n) for n, g in res["cpu"][1].items())
    if d_logits > TOL_LOGITS or d_grads[0] > TOL_GRADS:
        raise AssertionError(f"swin fp32 card vs CPU: logits {d_logits:.3e} "
                             f"(tol {TOL_LOGITS:g}), gradients "
                             f"{d_grads[0]:.3e} at {d_grads[1]} (tol "
                             f"{TOL_GRADS:g})")
    log(f"swin fp32 card vs CPU ({SWIN_MODEL}, embed search, batch 2): "
        f"logits {d_logits:.3e} (tol {TOL_LOGITS:g}), {len(res['cpu'][1])} "
        f"gradients, largest {d_grads[0]:.3e} at {d_grads[1]} (tol "
        f"{TOL_GRADS:g})")
    del res, p0, a0
    add(by_body(A))

    # (b) search -> compress -> postsearch -> export -> subnet, bf16
    batch = SWIN_BATCH
    bundle, state, step, images, labels = B.build_swin_step("swin_tiny",
                                                            batch)
    gen = torch.Generator(device="cuda").manual_seed(23)
    box = {"state": state}

    def search_call():
        box["state"], m = step(box["state"], images, labels, gen)
        return m
    m, dt = _timed_calls(search_call, SWIN_CALLS)
    m = _finite(m, "swin search step")
    with torch.no_grad():
        total, _ = swin_model_flops(state.alphas, state.arch, bundle.space,
                                    bundle.cfg)
    rates = {"search": batch / dt}
    mfu = rates["search"] * 6 * float(total) * 1e9 / BF16_FLOPS
    report, ms, _ = B.force_convergence(state, bundle.space)
    if not report.finish_search:
        raise AssertionError(f"swin: the forced compress did not converge: "
                             f"{report.events}")
    scfg, tx = B.search_config(batch)
    post = make_swin_search_step(bundle.space, bundle.cfg, scfg, tx,
                                 phase="postsearch", device="cuda")

    def post_call():
        box["state"], m = post(box["state"], images, labels, gen)
        return m
    pm, dt = _timed_calls(post_call, SWIN_CALLS)
    pm = _finite(pm, "swin postsearch step")
    rates["postsearch"] = batch / dt
    dense, dcfg, meta = export_swin_subnet(state.params, state.arch,
                                           bundle.space, bundle.cfg)
    xs = images[0, :4]
    with torch.no_grad():
        gated = swin_search_forward(state.params, state.alphas, state.arch,
                                    xs, bundle.cfg, bundle.space, **f32)
        fp, farch = fuse_swin_params(state.params, state.arch, bundle.space,
                                     bundle.cfg)
        fused = swin_search_forward(fp, state.alphas, farch, xs, bundle.cfg,
                                    bundle.space, fused=True, **f32)
        sliced = swin_forward(dense, xs, dcfg, **f32)
    d_fused, d_sliced = _rel(fused, gated), _rel(sliced, gated)
    if max(d_fused, d_sliced) > TOL_LOGITS:
        raise AssertionError(f"swin gated vs fused {d_fused:.3e}, vs sliced "
                             f"{d_sliced:.3e} (tol {TOL_LOGITS:g})")
    del fp, dense
    _, _, _, fstate, train, evaluate = B.build_swin_subnet_steps(
        bundle, state, batch)
    sub = fstate.params
    fbox = {"state": fstate}

    def train_call():
        fbox["state"], m = train(fbox["state"], images, labels, gen)
        return m
    tm, dt = _timed_calls(train_call, SWIN_CALLS)
    tm = _finite(tm, "swin subnet train step")
    rates["subnet train"] = batch / dt
    em, dt = _timed_calls(lambda: evaluate(sub, images[0], labels[0]),
                          SWIN_CALLS)
    _finite(em, "swin subnet eval step")
    rates["subnet eval"] = batch / dt
    add(by_body(A))
    log(f"swin lifecycle on {card}, batch {batch}, bf16: search step "
        f"{rates['search']:.2f} img/s over {SWIN_CALLS} calls after one "
        f"warm-up (loss {m['loss_total']:.4f}, searched "
        f"{m['searched_gflops']:.3f} of {float(total):.3f} GFLOPs, MFU "
        f"{mfu:.4f}); forced compress {ms:.1f} ms ({len(report.events)} "
        f"events); postsearch {rates['postsearch']:.2f} img/s over "
        f"{SWIN_CALLS} calls (loss "
        f"{pm['loss_total']:.4f}); export: stage_dims {meta['stage_dims']}, "
        f"mlp {[b['mlp_hidden'] for b in meta['blocks']]}; fp32 gated vs "
        f"fused {d_fused:.3e}, vs sliced {d_sliced:.3e} (tol "
        f"{TOL_LOGITS:g}); subnet train {rates['subnet train']:.2f} img/s "
        f"(loss {tm['loss']:.4f}), eval {rates['subnet eval']:.2f} img/s")
    del state, box, fstate, fbox, sub, train, evaluate, step, post
    torch.cuda.empty_cache()

    # (c) the planned search step: graph replays against eager
    bundle, state, _, _, _ = B.build_swin_step("swin_tiny", batch, seed=1)
    pstep, _ = make_planned_swin_search_step(
        bundle.space, bundle.cfg, scfg, tx, phase="search",
        steps_per_epoch=9, device="cuda")
    calls, worst = graph_vs_eager("swin search step", pstep, state, batch,
                                  True)
    times = B.time_planned(calls, SWIN_CALLS, rounds=2)
    log(f"swin planned search step on {card}, batch {batch}: img/s graph "
        f"{[round(batch / t, 2) for t in times['graph']]}, eager "
        f"{[round(batch / t, 2) for t in times['eager']]}")
    del state, calls, pstep
    torch.cuda.empty_cache()
    add(by_body(A))

    # (d) the CLIs
    sdir = os.path.join(root, "swin_search")
    data = ["--data-set", "SYNTHETIC", "--synthetic-size", str(SWIN_IMAGES),
            "--batch-size", str(batch)]
    _, text, counts, dt = run_cli(A, search_swin, data + [
        "--model", SWIN_MODEL, "--epochs", "1", "--embed_search",
        "--cache-device", "--planned-epoch", "--force-finish",
        "--export-finetune-epochs", "1", "--output_dir", sdir])
    add(counts)
    for name in ("running_ckpt", "best", "model_exported", "model_finetuned",
                 "log.txt"):
        if not os.path.exists(os.path.join(sdir, name)):
            raise AssertionError(f"cli.search_swin wrote no {name}")
    graphs = _graph_lines(text)
    if len(graphs) != 2 or any(c != 1 for c, _, _ in graphs):
        raise AssertionError(f"cli.search_swin: graph lines {graphs}")
    meta = ckpt.latest_meta(os.path.join(sdir, "model_exported"))
    log(f"cli.search_swin on {card} ({SWIN_IMAGES} images, batch {batch}, "
        f"planned): {dt:.1f} s; epochs (epoch, img/s, feed, dispatch, "
        f"readback, compress s) {_epochs(text)}; graphs {graphs}; exported "
        f"stage_dims {meta['stage_dims']}, acc1 {meta['acc1']:.2f}")
    for part in ("best", "model_exported"):
        stats, _, counts, dt = run_cli(A, eval_cli, data + [
            "--checkpoint", os.path.join(sdir, part)])
        add(counts)
        if not all(math.isfinite(v) for v in stats.values()):
            raise AssertionError(f"cli.eval of swin {part}: {stats}")
        log(f"cli.eval swin {part}: {stats} in {dt:.1f} s")
    ddir = os.path.join(root, "swin_dense")
    (_, best), text, counts, dt = run_cli(A, train_swin_dense, data + [
        "--model", "swin_tiny_patch4_window7_224", "--epochs", "1",
        "--eval-every", "1", "--cache-device", "--planned-epoch",
        "--output_dir", ddir])
    add(counts)
    if not os.path.exists(os.path.join(ddir, "model_finetuned", "meta.json")):
        raise AssertionError("cli.train_swin_dense wrote no model_finetuned")
    log(f"cli.train_swin_dense on {card} (1 epoch, planned): {dt:.1f} s; "
        f"epochs {_epochs(text)}; graphs {_graph_lines(text)}")
    del best
    torch.cuda.empty_cache()

    # (e) the committed TPU searches, exported on the card
    here = os.path.dirname(os.path.abspath(__file__))
    for run in SWIN_RUNS:
        bundle = create_model(SWIN_MODEL, device="cuda", embed_search=True)
        params, alphas, arch = bundle.init(0)
        ckpt.load_checkpoint(os.path.join(here, run, "best"), alphas=alphas,
                             arch=arch)
        passes = 0
        while not arch.all_finished and passes < 20:
            compress(params, alphas, arch, None, bundle.space, thresh=1.0)
            passes += 1
        dense, dcfg, meta = export_swin_subnet(params, arch, bundle.space,
                                               bundle.cfg)
        want = ckpt.latest_meta(os.path.join(here, run, "model_exported"))
        if (meta["stage_dims"], meta["blocks"]) != (want["stage_dims"],
                                                    want["blocks"]):
            raise AssertionError(f"{run}: exported {meta}, committed "
                                 f"{want['stage_dims']} {want['blocks']}")
        with torch.no_grad():
            out = swin_forward(dense, images[0, :8], dcfg)
        if not torch.isfinite(out).all():
            raise AssertionError(f"{run}: subnet logits not finite")
        log(f"tpu swin search {run}: {passes} compress passes to finish; "
            f"exported stage_dims {meta['stage_dims']}, mlp "
            f"{[b['mlp_hidden'] for b in meta['blocks']]}, equal to its "
            "committed model_exported/meta.json")
        del params, alphas, dense
    add(by_body(A))
    if any(totals.values()):
        raise AssertionError(f"swin: attention kernels launched {totals}; "
                             "its window attention is plain PyTorch")
    log(f"swin: attention launches over the phase {totals} (none expected)")
    return totals



# ---------------------------------------------------------------------------
# phase 12: data parallelism over torch.distributed (parallel/)
# ---------------------------------------------------------------------------

DIST_BATCH = 64            # the global batch of every phase-12 step
DIST_TIMEOUT = 300         # seconds a phase-12 process may take
DIST_CLI_IMAGES = 256      # SYNTHETIC train and val images of 12 (b)
DIST_CLI_EPOCHS = 3


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _dist_env(rank=None, world=None, **extra):
    """This environment without a launcher's variables, then the rank and
    world (on the one card) and `extra` when given."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
        "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    if rank is not None:
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    env.update(extra)
    return env


def _start(cmd, env):
    """A child in a session of its own, so that a timeout ends it and
    everything it started."""
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def _finish(procs, what):
    """Wait for every process (DIST_TIMEOUT in all); a timeout or a non-zero
    exit ends them all and fails the phase. Returns their stdouts."""
    import signal
    outs, deadline = [], time.perf_counter() + DIST_TIMEOUT
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(deadline - time.perf_counter(), 1.0))
            sys.stderr.write(err[-4000:])
            if p.returncode != 0:
                raise AssertionError(f"{what}: a process exited "
                                     f"{p.returncode}:\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    return outs


def _tagged(out, tag):
    """The JSON after `tag` on the last line of `out` that starts with it."""
    for line in reversed(out.splitlines()):
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    raise AssertionError(f"no {tag} line in:\n{out[-2000:]}")


def _worker_setup():
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _state_diff(what, got, want):
    """ArchState and counters bit-identical, every other tensor within
    TOL_GRAPH of the leaf's largest magnitude; returns (largest relative
    difference, its leaf)."""
    import torch
    from ofb_tpu_torch.core.steps import named_tensors
    worst = (0.0, "none")
    for (n, a), (_, b) in zip(named_tensors(got), named_tensors(want)):
        if n.startswith("arch.") or n == "step" or not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {n} differs")
            continue
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: {n} is not finite")
        d = _rel(a, b)
        worst = max(worst, (d, n))
    if worst[0] > TOL_GRAPH:
        raise AssertionError(f"{what}: {worst[1]} differs by "
                             f"{worst[0]:.3e} (tol {TOL_GRAPH:g})")
    return worst


def dist_step_worker():
    """12 (a), a process of its own with torchrun's environment for a world
    of one: the DeiT-S search step (bf16, batch 64) from one state and
    generator seed without a process group and then under NCCL, compared;
    the NCCL all-reduce of the step's gradient bucket timed; the planned
    search step captured as a CUDA graph with the all-reduce inside and
    replayed against eager calls. Prints `DIST_STEP {json}`."""
    _worker_setup()
    import copy
    import torch
    import torch.distributed as dist
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.core.optim import named_leaves
    from ofb_tpu_torch.core.steps import make_planned_search_step
    from ofb_tpu_torch.ops import attention as A
    from ofb_tpu_torch.parallel import distributed as D

    bundle, state, step, images, labels = B.build_step(
        "deit_small", DIST_BATCH, seed=12)
    ref, spare = copy.deepcopy(state), copy.deepcopy(state)

    def steps(st, n, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        m = None
        for _ in range(n):
            st, m = step(st, images, labels, g, 0.75)
        return st, m

    ref, m_ref = steps(ref, 1, 21)              # no process group
    spare, _ = steps(spare, 1, 22)              # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spare, _ = steps(spare, 3, 23)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / 3 * 1e3
    if D.init_distributed() != (0, 1) or dist.get_backend() != "nccl":
        raise AssertionError("12 (a): not rank 0 of a world of 1 on NCCL")
    A.reset_launch_counts()
    state, m = steps(state, 1, 21)
    torch.cuda.synchronize()
    step_counts = by_body(A)
    if step_counts != only("resident", 12, 12):
        raise AssertionError(f"12 (a): the NCCL step launched {step_counts}")
    worst = _state_diff("12 (a)", state, ref)
    loss_rel = abs(m["loss_total"].item() - m_ref["loss_total"].item()) \
        / abs(m_ref["loss_total"].item())
    spare, _ = steps(spare, 1, 24)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spare, _ = steps(spare, 3, 25)
    torch.cuda.synchronize()
    nccl_ms = (time.perf_counter() - t0) / 3 * 1e3

    # the gradient bucket of the step: every leaf and six metrics
    bucket = [torch.zeros_like(p) for p in
              named_leaves(state.params, state.alphas).values()] + \
        [torch.zeros((), device="cuda") for _ in range(6)]
    nbytes = sum(t.numel() * t.element_size() for t in bucket)
    D.all_mean_(bucket)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        D.all_mean_(bucket)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    dev_ms = device_time_ms(lambda: D.all_mean_(bucket), iters=10)
    del bucket, spare, ref

    # the planned step at world 1 captures the all-reduce in its graph
    A.reset_launch_counts()
    scfg, tx = B.search_config(DIST_BATCH)
    pstep, _ = make_planned_search_step(
        bundle.space, bundle.cfg, scfg, tx, phase="search",
        steps_per_epoch=9, device="cuda")
    _, graph_worst = graph_vs_eager("search step under NCCL", pstep, state,
                                    DIST_BATCH, True, K=2)
    graph_counts = by_body(A)
    dist.destroy_process_group()
    counts = {k: kernel_counts(step_counts).get(k, 0)
              + kernel_counts(graph_counts).get(k, 0)
              for k in kernel_counts(only("resident", 0, 0))}
    print("DIST_STEP " + json.dumps({
        "max_diff": worst[0], "max_diff_leaf": worst[1], "loss_rel": loss_rel,
        "graph_max_diff": graph_worst, "plain_step_ms": plain_ms,
        "nccl_step_ms": nccl_ms, "bucket_mb": nbytes / 2**20,
        "allreduce_host_ms": host_ms, "allreduce_wall_ms": wall_ms,
        "allreduce_device_ms": dev_ms, "step_launches": step_counts,
        "graph_launches": graph_counts, "counts": counts}), flush=True)


def dist_clis_worker(root):
    """12 (b), rank 0 of `torchrun --standalone --nproc_per_node 1`: the
    CLIs in this process through their parsers and `main`, DeiT-S, bf16,
    batch 64, SYNTHETIC at staging 256: `cli.search` (compress threshold
    1.0: search, the finish, postsearch, the fuse of best/), `cli.export`,
    one `cli.finetune` epoch and `cli.eval` of its best; each joins the
    launcher's NCCL group and counts its attention launches from 0.
    Prints `DIST_CLIS {json}`."""
    _worker_setup()
    import torch
    import torch.distributed as dist
    from ofb_tpu_torch.cli import eval as eval_cli
    from ofb_tpu_torch.cli import export, finetune, search
    from ofb_tpu_torch.ops import attention as A

    n = DIST_CLI_IMAGES
    steps = n_val = n // DIST_BATCH
    world_line = "distributed: rank 0 of world 1, backend nccl, device cuda:0"
    data = ["--data-set", "SYNTHETIC", "--synthetic-size", str(n),
            "--batch-size", str(DIST_BATCH)]
    sdir, xdir, fdir = (os.path.join(root, d) for d in
                        ("dist_search", "dist_exported", "dist_finetune"))
    runs = {}

    def cli(name, module, argv, fwd, bwd):
        out, text, counts, dt = run_cli(A, module, argv)
        if world_line not in text:
            raise AssertionError(f"12 (b) {name}: no '{world_line}' line")
        _expect_counts(counts, fwd, bwd, f"12 (b) {name}")
        runs[name] = {"counts": counts, "seconds": dt,
                      "epochs": _epochs(text)}
        return out, text

    E = DIST_CLI_EPOCHS
    _, text = cli("search", search, data + [
        "--model", "deit_small_patch16_224_mim", "--accum-iter", "1",
        "--mixup", "0.8", "--cutmix", "1.0", "--compress-thresh", "1.0",
        "--epochs", str(E), "--output_dir", sdir],
        12 * (E * steps + (E + 1) * n_val), 12 * E * steps)
    if "== finish_search" not in text or "saved model_fused" not in text:
        raise AssertionError("12 (b): the search did not finish and fuse")
    for row in _log(os.path.join(sdir, "log.txt")):
        if not all(math.isfinite(v) for k, v in row.items()
                   if k.startswith("train_loss")):
            raise AssertionError(f"12 (b): a loss is not finite: {row}")
    cli("export", export, ["--checkpoint", os.path.join(sdir, "best"),
                           "--out", xdir], 0, 0)
    # the raw and the EMA weights are both evaluated
    cli("finetune", finetune, data + [
        "--finetune", xdir, "--epochs", "1", "--output_dir", fdir],
        12 * (steps + 2 * n_val), 12 * steps)
    if not math.isfinite(_log(os.path.join(fdir, "log.txt"))[-1]
                         ["train_loss"]):
        raise AssertionError("12 (b): the finetune loss is not finite")
    stats, _ = cli("eval", eval_cli, data + [
        "--checkpoint", os.path.join(fdir, "best")], 12 * n_val, 0)
    if not (0.0 <= stats["acc1"] <= 100.0 and math.isfinite(stats["loss"])):
        raise AssertionError(f"12 (b) eval: {stats}")
    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)
    for r in runs.values():
        _add(totals, r["counts"])
    torch.cuda.synchronize()
    dist.destroy_process_group()
    print("DIST_CLIS " + json.dumps({"runs": runs, "eval": stats,
                                     "counts": totals}), flush=True)


def _pair_val(bundle):
    """The val set of 12 (c): DIST_BATCH images and labels from a seed."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(14)
    S = bundle.cfg.img_size
    return (torch.rand((DIST_BATCH, S, S, 3), generator=g, device="cuda"),
            torch.randint(0, bundle.cfg.num_classes, (DIST_BATCH,),
                          generator=g, device="cuda"))


def dist_pair_worker(rank, rdzv, out):
    """12 (c), one of two ranks that share the one card over gloo: two
    DeiT-S search steps on this rank's half of a global batch of 64, a
    compress pass on crafted alphas that converges every module (crafted
    on rank 0 only: rank 1 must take rank 0's decisions), an eval over
    this rank's half of the val set. Rank 0 writes its weights after the
    steps and its state after the compress to `out`. Prints
    `DIST_PAIR {json}`."""
    _worker_setup()
    import hashlib
    import torch
    import torch.distributed as dist
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.core.compress import compress
    from ofb_tpu_torch.core.engine import evaluate
    from ofb_tpu_torch.core.optim import named_leaves
    from ofb_tpu_torch.core.steps import make_eval_step
    from ofb_tpu_torch.ops import attention as A
    from ofb_tpu_torch.parallel import distributed as D
    from ofb_tpu_torch.core.steps import named_tensors
    from ofb_tpu_torch.parallel.mesh import local_rows

    if D.init_distributed("gloo", init_method=f"file://{rdzv}") != (rank, 2):
        raise AssertionError("12 (c): not a world of 2")
    bundle, state, step, images, labels = B.build_step(
        "deit_small", DIST_BATCH, seed=13)
    x = local_rows(images, rank, 2, dim=1)
    y = local_rows(labels, rank, 2, dim=1)
    g = torch.Generator(device="cuda").manual_seed(22)
    A.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(2):
        state, m = step(state, x, y, g, 0.75)
        metrics.append(_finite(m, "12 (c)"))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 2
    step_counts = by_body(A)
    leaves = {n: p.detach().cpu() for n, p in
              named_leaves(state.params, state.alphas).items()}
    h = hashlib.sha256()
    for t in leaves.values():
        h.update(t.numpy().tobytes())
    if rank == 0:
        torch.save(leaves, os.path.join(out, "steps.pt"))

    if rank == 0:
        report = B.force_convergence(state, bundle.space)[0]
    else:                       # the same two passes, on uncrafted alphas
        report = compress(state.params, state.alphas, state.arch,
                          state.opt_state, bundle.space)[4]
        compress(state.params, state.alphas, state.arch, state.opt_state,
                 bundle.space)
    if not state.arch.all_finished:
        raise AssertionError(f"12 (c) rank {rank}: compress left modules "
                             f"open: {report.events}")
    d = hashlib.sha256(repr(report.events).encode())
    for _, t in named_tensors((state.arch, state.alphas)):
        d.update(t.detach().cpu().numpy().tobytes())
    if rank == 0:
        torch.save({"leaves": {n: p.detach().cpu() for n, p in named_leaves(
            state.params, state.alphas).items()},
            "arch": [t.cpu() for _, t in named_tensors(state.arch)]},
            os.path.join(out, "compressed.pt"))

    vx, vy = _pair_val(bundle)
    ev = make_eval_step(bundle.space, bundle.cfg, device="cuda")
    A.reset_launch_counts()
    stats = evaluate(ev, [(vx[rank::2], vy[rank::2])], state.params,
                     state.alphas, state.arch, print_fn=lambda *a: None)
    eval_counts = by_body(A)
    D.barrier_sync("12 (c) done")
    dist.destroy_process_group()
    counts = {k: kernel_counts(step_counts).get(k, 0)
              + kernel_counts(eval_counts).get(k, 0)
              for k in kernel_counts(only("resident", 0, 0))}
    print("DIST_PAIR " + json.dumps({
        "rank": rank, "step_digest": h.hexdigest(), "digest": d.hexdigest(),
        "events": len(report.events), "eval": stats, "metrics": metrics,
        "step_s": step_s, "step_launches": step_counts,
        "eval_launches": eval_counts, "counts": counts}), flush=True)


def run_dist(A, card, root):
    """Phase 12: data parallelism (see the module docstring). Returns the
    launches of the distributed path: 12 (a), (b) and both ranks of (c)."""
    import torch
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.core.engine import evaluate
    from ofb_tpu_torch.core.optim import named_leaves
    from ofb_tpu_torch.core.steps import make_eval_step
    from ofb_tpu_torch.core.steps import named_tensors

    torch.cuda.empty_cache()
    me = os.path.abspath(__file__)
    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)

    # (a) a world of one over NCCL, step by step
    t0 = time.perf_counter()
    port = str(_free_port())
    out, = _finish([_start([sys.executable, me, "--dist-step"], _dist_env(
        0, 1, MASTER_ADDR="localhost", MASTER_PORT=port))], "12 (a)")
    a = _tagged(out, "DIST_STEP")
    for k, n in a["counts"].items():
        totals[k] += n
    log(f"dist (a) NCCL world of 1 on {card}: the search step equals the "
        f"ungrouped one (ArchState bit-identical, largest difference "
        f"{a['max_diff']:.3e} at {a['max_diff_leaf']}, loss rel "
        f"{a['loss_rel']:.3e}; tol {TOL_GRAPH:g}); step "
        f"{a['plain_step_ms']:.2f} ms ungrouped, {a['nccl_step_ms']:.2f} ms "
        f"under NCCL (3 steps each, host-timed); the gradient bucket "
        f"({a['bucket_mb']:.1f} MiB) all-reduce with pack and unpack "
        f"{a['allreduce_device_ms']:.4f} ms device time, "
        f"{a['allreduce_host_ms']:.4f} ms host, {a['allreduce_wall_ms']:.4f}"
        f" ms wall a call; the planned step's graph with the all-reduce "
        f"inside against eager: {a['graph_max_diff']:.3e}; launches step "
        f"{a['step_launches']}, graph run {a['graph_launches']}; "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) the CLIs under torchrun --standalone --nproc_per_node 1
    t0 = time.perf_counter()
    out, = _finish([_start([sys.executable, "-m", "torch.distributed.run",
                            "--standalone", "--nproc_per_node", "1", me,
                            "--dist-clis", root],
                           _dist_env())], "12 (b)")
    b = _tagged(out, "DIST_CLIS")
    for k, n in b["counts"].items():
        totals[k] += n
    srch = b["runs"]["search"]
    log(f"dist (b) torchrun --nproc_per_node 1, NCCL: cli.search "
        f"{len(srch['epochs'])} epochs, sustained img/s by epoch "
        f"{[round(e[1], 1) for e in srch['epochs']]} (SYNTHETIC "
        f"{DIST_CLI_IMAGES}; phase 7's classic run without a group, "
        f"SYNTHETIC 1024: {RATES.get('search')}); finetune "
        f"{[round(e[1], 1) for e in b['runs']['finetune']['epochs']]} "
        f"img/s; eval {b['eval']}; seconds by CLI "
        f"{ {k: round(r['seconds'], 1) for k, r in b['runs'].items()} }; "
        f"launches by CLI { {k: r['counts'] for k, r in b['runs'].items()} }"
        f"; all resident; {time.perf_counter() - t0:.1f} s")

    # (c) two ranks sharing the card over gloo, against one process
    t0 = time.perf_counter()
    pair = tempfile.mkdtemp(prefix="ofb_pair_", dir=root)
    outs = _finish([_start([sys.executable, me, "--dist-pair", str(r),
                            os.path.join(pair, "rdzv"), pair],
                           _dist_env(r, 2)) for r in range(2)], "12 (c)")
    r0, r1 = (_tagged(o, "DIST_PAIR") for o in outs)
    pair_s = time.perf_counter() - t0
    for key in ("step_digest", "digest", "eval", "metrics"):
        if r0[key] != r1[key]:
            raise AssertionError(f"12 (c): the ranks differ in {key}: "
                                 f"{r0[key]} / {r1[key]}")
    for r in (r0, r1):
        if r["step_launches"] != only("resident", 24, 24) or \
                r["eval_launches"] != only("resident", 12, 0):
            raise AssertionError(f"12 (c) rank {r['rank']}: launches "
                                 f"{r['step_launches']}, eval "
                                 f"{r['eval_launches']}")
        for k, n in r["counts"].items():
            totals[k] += n
    # one process over the global batch of 64, from the same state
    bundle, state, step, images, labels = B.build_step(
        "deit_small", DIST_BATCH, seed=13)
    init = {n: p.detach().clone() for n, p in
            named_leaves(state.params, state.alphas).items()}
    g = torch.Generator(device="cuda").manual_seed(22)
    for _ in range(2):
        state, m = step(state, images, labels, g, 0.75)
    got = torch.load(os.path.join(pair, "steps.pt"))
    want = {n: p.detach() for n, p in
            named_leaves(state.params, state.alphas).items()}
    # a leaf with a scale of its own: the (a) measure. A leaf that starts
    # at 0 (biases, layer-norm shifts) holds only its two Adam updates,
    # each about +-lr whatever the gradient's size, so a gradient that
    # rounds to the other sign in bf16 (a batch of 32 against 64) flips
    # them: there the ranks may differ from one process by at most twice
    # the furthest that any such leaf moved
    worst, zero = (0.0, "none"), (0.0, 0.0, "none")
    for n, w in want.items():
        a = got[n].to(w.device)
        if init[n].abs().max() > 0:
            worst = max(worst, (_rel(a, w), n))
        else:
            zero = max(zero, ((a - w).abs().max().item(),
                              (w - init[n]).abs().max().item(), n))
    moved = max((w - init[n]).abs().max().item() for n, w in want.items()
                if init[n].abs().max() == 0)
    if worst[0] > TOL_GRAPH or zero[0] > 2 * moved:
        raise AssertionError(f"12 (c): the ranks' weights and one "
                             f"process's differ at {worst[1]} by "
                             f"{worst[0]:.3e} (tol {TOL_GRAPH:g}); at the "
                             f"zero-started {zero[2]} by {zero[0]:.3e} "
                             f"(bound {2 * moved:.3e})")
    del init
    loss_rel = abs(r0["metrics"][-1]["loss_total"]
                   - m["loss_total"].item()) / abs(m["loss_total"].item())
    # the whole val set in one process, from rank 0's compressed state,
    # in the ranks' two batches: the sums must be the ranks' exactly
    saved = torch.load(os.path.join(pair, "compressed.pt"))
    with torch.no_grad():
        for n, p in named_leaves(state.params, state.alphas).items():
            p.copy_(saved["leaves"][n])
        for t, s in zip((t for _, t in named_tensors(state.arch)),
                        saved["arch"]):
            t.copy_(s)
    vx, vy = _pair_val(bundle)
    ev = make_eval_step(bundle.space, bundle.cfg, device="cuda")
    one = evaluate(ev, [(vx[r::2], vy[r::2]) for r in range(2)],
                   state.params, state.alphas, state.arch,
                   print_fn=lambda *a: None)
    if one != r0["eval"]:
        raise AssertionError(f"12 (c): the ranks' eval {r0['eval']} is not "
                             f"one process's over the whole set {one}")
    del state, got, saved
    A.reset_launch_counts()
    shutil.rmtree(pair, ignore_errors=True)
    log(f"dist (c) two ranks on one card over gloo (a correctness run, not "
        f"a speed figure: gloo stages card tensors through the host) on "
        f"{card}: weights after 2 steps bit-identical across the ranks and "
        f"within {worst[0]:.3e} ({worst[1]}) of one process on the global "
        f"batch, the zero-started leaves within {zero[0]:.3e} ({zero[2]}; "
        f"the furthest such a leaf moved: {moved:.3e}) (loss rel "
        f"{loss_rel:.3e}); compress ({r0['events']} events) "
        f"digests equal; eval {r0['eval']} on both ranks = one process over "
        f"the whole set; step {r0['step_s'] * 1e3:.1f} / "
        f"{r1['step_s'] * 1e3:.1f} ms by rank; launches each rank: steps "
        f"{r0['step_launches']}, eval {r0['eval_launches']}; "
        f"{pair_s:.1f} s")
    return totals


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
    seconds = {"build": round(time.perf_counter() - t0, 1)}

    def timed(phase, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[phase] = round(time.perf_counter() - t, 1)
        return out

    errs = timed("2", check_kernels, A)
    timed("2 repeats", check_streaming_repeats, A)
    times = timed("3", time_kernels, A)
    subnet_times = timed("3 subnet", time_subnet_shapes, A)
    stream_times, stream_fields = timed("3 streaming", time_streaming, A)
    vit_times = timed("3 vit", time_vit_family, A)
    fp32_times, fp32_fields = timed("3 fp32", time_general_fp32, A)
    fp32 = timed("4", check_against_cpu, A)
    small = timed("4 small heads", check_small_heads, A)
    launches = timed("5", run_slice, A)
    lifecycle = timed("6", run_lifecycle, A, smi)
    root = tempfile.mkdtemp(prefix="ofb_cli_")
    try:
        cli = timed("7", run_clis, A, smi, root)
        at384 = timed("8", run_384, A, smi, root)
        planned = timed("9", run_planned, A, smi, root)
        vit, vit_fp32 = timed("10", run_vit_family, A, smi, root)
        swin = timed("11", run_swin, A, smi, root)
        dist = timed("12", run_dist, A, smi, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"seconds by phase: {json.dumps(seconds)}")

    kernels = []
    for name, src, line in (
            ("attention_fwd", "attention_fwd_resident.cu", 68),
            ("attention_bwd", "attention_bwd_resident.cu", 81),
            ("attention_fwd_general", "attention_fwd.cu", 68),
            ("attention_bwd_general", "attention_bwd.cu", 81),
            ("attention_fwd_streaming", "attention_fwd_streaming.cu", 115),
            ("attention_bwd_streaming", "attention_bwd_streaming.cu", 127)):
        phases = dict(launches_fp32=fp32[name] + small[name]
                      + vit_fp32.get(name, 0),
                      launches_search=launches[name],
                      launches_lifecycle=lifecycle[name],
                      launches_cli=cli[name], launches_384=at384[name],
                      launches_planned=planned[name],
                      launches_vit=vit[name], launches_swin=swin[name],
                      launches_dist=dist[name])
        # the streaming body's times are at 577 tokens; the general body's
        # in fp32 at 197 tokens (its 577-token times stand beside them)
        timed = stream_fields[name] if name.endswith("_streaming") \
            else fp32_fields[name] if name.endswith("_general") \
            else dict(times[name])
        kernels.append(dict(
            name=name, route="cuda", source=f"ofb_tpu_torch/csrc/{src}",
            replaces=f"{ATTN_SRC}:{line}", launches=sum(phases.values()),
            **phases, max_abs_err=errs[name], **timed))
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels no driven path launched: {idle}")
    log(json.dumps({"subnet_attention": subnet_times}))
    log(json.dumps({"attention_577": stream_times}))
    log(json.dumps({"attention_vit": vit_times}))
    log(json.dumps({"attention_fp32": fp32_times}))
    log("device time: profiler sessions taken as whole {whole}, taken as "
        "agreeing {agreed}, dropped {dropped}; times from queued_time_ms "
        "{queued}".format(**SESSIONS))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    # the processes of phase 12 run this file with a role
    if sys.argv[1:2] == ["--dist-step"]:
        dist_step_worker()
    elif sys.argv[1:2] == ["--dist-clis"]:
        dist_clis_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--dist-pair"]:
        dist_pair_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        sys.exit(main())
