#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ofb_tpu_torch) on one GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each of
which raises (and so exits non-zero) on failure:

  1. card: name and power limit, CUDA version, and the build of every
     kernel from ofb_tpu_torch/csrc (one nvcc per source, in parallel);
  2. kernels: each kernel's wrapper against its plain PyTorch twin on the
     same inputs, all four bodies (the resident, the streaming and the
     unaligned `wgmma` ones in bf16, the general one in fp32, each asked
     for by name), at the DeiT-S shapes of the search step, the exported
     subnet's shapes (head dims 8 * odd among them, which the `wgmma`
     bodies run zero-padded to the next multiple of 16), ragged shapes and
     head dims that are not a multiple of 8 (4, 6, 12, 36: the unaligned
     body's in bf16, the general body's in fp32; TF32 off), the unaligned
     and the general bodies also on views whose rows start one element
     into a wider buffer (no row 16-byte aligned), and the unaligned body
     at UNALIGNED (an odd head dim at 577 tokens, one token, d = 128 one
     element in) and at phase 3's UNALIGNED_TIMING;
     the streaming body at DeiT-S and DeiT-B at 384 pixels (577 tokens),
     ragged token counts up to 1025, 8 * odd head dims at 577 and, named,
     at 1, 17 and 197 tokens; every output finite; then the streaming
     pair's determinism at DeiT-S-384 and ViT-H/14 (STREAM_REPEAT): a
     second call, and a CUDA graph of forward + backward replayed, equal
     the first eager call bit for bit;
  3. timing: the resident and the unaligned bodies of each kernel with
     CUDA events at batch 256, in turns (unaligned, resident, resident,
     unaligned), beside the bound, the
     plain twin and torch's scaled_dot_product_attention (timed here as a
     yardstick only; the port never calls it); the resident body also at
     batch 64; then at each attention shape of the exported subnet, batch
     256: resident, unaligned (asked for by name), twin and SDPA. Each of
     these also as device time (torch.profiler: the kernels' summed
     durations, the host's dispatch left out; a session that lost kernel
     records is run again). At 577 tokens (DeiT-S and DeiT-B at 384
     pixels, and an exported subnet's 2 x 24 head) the unaligned and the
     streaming bodies in turns the same way, beside the twin, SDPA, the
     bytes and the operations bounds; the streaming body must be the
     faster at DeiT-S (its ratio to SDPA is printed, not asserted: timing
     noise across cards would fail honest runs). Then the unaligned body
     at UNALIGNED_TIMING (DeiT-S's view one element in, the search grids'
     head dims 20 and 36 at 197 and 577 tokens, the story's 17 tokens)
     beside the twin, SDPA and the bound. Then each attention shape
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
     56 among them, through the resident body, none through another;
  7. the CLIs, in process through each one's parser and `main`, DeiT-S at
     full width and depth, batch 64, bf16, SYNTHETIC data at staging 256:
     `cli.search` (fused RandAugment m9 + erasing, Mixup / CutMix after the
     finish, compress threshold 1.0; 4 epochs: search, the finish,
     postsearch, the fuse of the best checkpoint), a resumed fifth epoch,
     `cli.export` of the best checkpoint, one `cli.finetune` epoch of the
     subnet (EMA, device cache) and `cli.eval` of its best. Checks the
     artifacts, log.txt's keys against the JAX CLI's, finite losses,
     accuracies in [0, 100], and each run's attention launches counted from
     0 against what `attention_body` predicts (all resident);
     prints each run's sustained epoch img/s and the split of its epochs,
     the compress passes' host ms, and the device time of
     `apply_train_augment` at batch 256 next to the search step's;
  8. the 384-pixel path, in process through the CLIs, bf16, batch 64,
     SYNTHETIC at staging 256: `cli.finetune --model deit_small_patch16_384
     --input-size 384 --from-scratch` for one epoch (device cache) and
     `cli.eval` of its best; then phase 7's exported subnet finetuned for
     one epoch at `--input-size 384` (its pos-embed resized 197 -> 577)
     and evaluated. Every attention launch of the four runs, counted from
     0, must take the streaming body (577 tokens), none another.

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
     through the CLIs, SYNTHETIC 512 (VIT_IMAGES; 1024 before phase 14
     came) at staging 256, bf16: `cli.finetune
     --from-scratch --cache-device` one epoch and `cli.eval` of its best
     for ViT-B/16 (batch 64, resident body), ViT-L/16 at 384 and ViT-H/14
     (batch 32, streaming body); one eval batch of the in21k ViT-B/16
     (pre-logits), the MIIL ViT-B/16 (no qkv bias) and the 8 x 96
     vit_small, and their fp32 logits and gradients on the card against
     the CPU's. No bf16 run launches the unaligned or the general body.

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
     committed widths. Swin's window attention runs on its own kernel pair
     (ops/window_attention.py; the JAX package's is plain jnp): the phase
     asserts that no attention kernel launched, that the window kernels
     did (12 + 12 a replay of the planned step), holds the bf16 pair to
     its plain version at Swin-T's four stage shapes at batch 256 (out,
     lse, dqkv and the bias table's gradient; max_abs_err a row in the
     `window_attention` line), and times it there beside its bound (the
     benchmark's `window_flops`), its plain version, the eager chain it
     replaced and torch's SDPA with the bias and mask as an additive mask,
     with the peak memory of each.
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
     fails or outlasts DIST_TIMEOUT fails the phase;
 13. tensor parallelism, resume and remat (`--tp-step RANK WORLD RDZV OUT
     [FROM]` runs a rank): (a) two and (b) four ranks sharing the card
     over gloo (a correctness run), each a (1, tp) mesh with DeiT-S (bf16,
     global batch TP_BATCH) sharded on its model axis (heads 3 + 3; 2 + 2
     + 1 + 1): a search step, block 0's MLP alpha cell at -8 and a
     compress pass, the state saved (every rank; rank 0 writes the
     gathered tensors, the PMIM generator's state in the meta), a
     post-prune step, the same step resumed from that file in a fresh
     supernet sharded on the same mesh (its metrics and watched leaves
     bit-equal to the uninterrupted step's), a forced convergence and the
     export; against the same sequence in one process on the card: the
     loss within TOL_TP_LOSS and the gradient norm within
     TOL_TP_GRAD_NORM, the updates of every qkv, proj, fc1 and fc2 weight
     and bias and of the alphas of the same sign but for TOL_TP_FLIPS of
     their elements and their difference within TOL_TP_REL, the same
     compress events and export widths, and the rank's export within
     TOL_TP_EXPORT of one process's; each rank's peak memory beside one
     process's. Across meshes, (a)'s checkpoint resumed by (b)'s ranks and
     by the one process: each post-prune step within the same TOL_TP_*
     of that mesh's own. Resident launches a rank 36 + 36 on (a), 48 + 48
     on (b), and 12 + 12 of the one process's resumed step. Meanwhile the
     resident
     pair against its twin at a rank's head counts (3, 2, 1 at N 197, d
     64) and (d) `python -m ofb_tpu_torch.dryrun --devices 4 --tiny
     --device cuda` exits 0. (c) the search step with `remat` against the
     plain one, DeiT-S and DeiT-B at REMAT_BATCH from one seed: equal
     after a step (ArchState bit-identical, the rest within TOL_GRAPH),
     then ms a step in turns and each step's peak memory.
 14. the ladder (`run_ladder`): `bash ofb_tpu_torch/scripts/ladder_imnet.sh`
     as a user runs it, DeiT-S at full width and depth (bf16, 224 px,
     batch 64, the JAX script's --cache-device --planned-epoch), two FLOPs
     targets (LADDER_TARGETS), EPOCHS 3 with FUSE_POINT 1 (the search CLI
     breaks after the fuse-point epoch, so stage 1 runs epochs 0 and 1 and
     stage 2 resumes for epoch 2) and one finetune epoch, on a small
     ImageFolder of JPEGs that `make_imagefolder` writes (IMNET; the
     card's installation has Pillow, and no libjpeg headers for the native
     decoder, so the JPEGs decode through Pillow). A `sitecustomize.py`
     of this script's, on PYTHONPATH for the ladder only, prints each
     process's attention launches (`LADDER_LAUNCHES`) into its stage's log
     at exit and keeps a copy of the running checkpoint a stage-1 search
     leaves (`stage1_ckpt`). Asserted: stage 1 stops at the fuse point and
     stage 2 resumes at epoch 2; ft/best, ft/running_ckpt and
     dense_ft/best exist; ladder.json has the dense row and one row a
     rung, each row's GFLOPs `dense_vit_gflops` of its exported model_cfg;
     every STATUS.json says the rung is done; resident launches in every
     search and finetune stage and none of another body; then the same
     command again skips every stage (no log gains an epoch line) and
     leaves ladder.json byte-identical; then, side by side (they touch
     other files of the root), `ladder_hard_eval` writes an acc1 in
     [0, 100] for every target (into a file of its own, so that the
     table stays the ladder's), `prune_timeline` reads a rung's
     search1.log, and a rung whose running_ckpt is put back to the
     stage-1 copy resumes stage 2 at epoch 2 (no epoch 0 or 1 again).
     Each stage's seconds and sustained epoch img/s are printed.
 15. the tools and examples (`run_tools`), each through its `main(argv)`
     in this process, its attention launches counted from 0:
     `scripts.perf_breakdown` (DeiT-S, batch 256, 20 steps: the six rows,
     every img/s and MFU finite and positive, eval_fwd faster than
     search_step, (2 + 20) x 12 resident launches a row, 5 rows forward
     and 4 backward), `scripts.augment_breakdown` (256, 256 -> 224, 20
     iterations; the bf16 geometry's mean delta within one uint8 step),
     `scripts.swin_breakdown` (Swin-T, batch 128; its stubs restored),
     `scripts.kpad_probe` (its shapes; also once as `python -m`, beside
     the writing of the ImageFolder), `scripts.data_bench`
     (256 JPEGs from `make_imagefolder`; Pillow only where the native
     decoder does not build), `examples.minimal_search` (fp32: 12 + 12
     general launches), `examples.compression_story` (1500 search and 600
     finetune steps; exported FLOPs below dense; its launches by body
     reported) and `dryrun.entry()` (finite (8, 1000) logits, 12 resident
     launches); then, where the story's subnet has head dims off a
     multiple of 8, the unaligned body at its shapes (batch 128) beside
     the twin, SDPA and the bound;
 16. the layer-norm kernel pair (ops/layer_norm.py): each kernel against
     its plain version in bf16 and fp32 at the main path's shapes and
     ragged ones (D 96, 276, 1280, odd row counts, a mask with no live
     channel), dropped channels exact, a second backward and a CUDA graph
     replay bit-equal; timed in bf16 at the search's and the finetune's
     shapes beside the bytes bound (each kernel at LN_MIN_BOUND or more),
     the eager chain it replaced and torch's layer_norm (the yardstick
     only); the launches a replay of the planned search (4 microbatches),
     one data-parallel rank's search and the dense finetune step runs.

The line before the last is the kernels' JSON (`launches` sums the twelve
driven paths, `launches_fp32`, `launches_search`, `launches_lifecycle`,
`launches_cli`, `launches_384`, `launches_planned`, `launches_vit`,
`launches_swin` (0: phase 11's window kernels are counted in its own
`window_attention` line), `launches_dist` (phase 12's processes),
`launches_tp` (phase 13's (a) to (c) with the resumed steps),
`launches_ladder` (phase 14's
processes) and `launches_tools` (phase 15) give each;
the general body's times are fp32's; the unaligned body's are at the
first shape of UNALIGNED_TIMING, with every timed shape under `shapes` and
the shapes at which phase 15 checked and timed it under `story`), after
phase 16's `layer_norm` line; the last line is {"ok": true,
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
# the unaligned body (bf16) and the general body (fp32) take: DeiT's 197
# tokens, a Swin window with its cls, DeiT at 384 pixels, a ragged count
SMALL_HEADS = [(2, 197, 2, 12), (3, 50, 3, 6), (2, 577, 2, 36), (3, 17, 1, 4)]
# the unaligned body in bf16 and the general body in fp32: head dims off
# multiples of 8; asked for by name at the resident and the streaming
# bodies' shapes too
GENERAL = [DEIT_S, (2, 257, 2, 64), (2, 577, 2, 64)] + RAGGED + SUBNET \
    + SMALL_HEADS
# ... and as views whose rows start one element into a wider buffer, so that
# no row is 16-byte aligned (the 4-byte copies of the fp32 kernels; bf16
# rows that start on 2 bytes only)
GENERAL_UNALIGNED = SMALL_HEADS + [(2, 197, 2, 64), (3, 17, 2, 40)]
# the unaligned body, (shape, offset in elements): an odd head dim above
# 256 tokens (rows on 2 bytes), one token, the widest head one element in
UNALIGNED = [((2, 577, 2, 21), 0), ((3, 1, 2, 20), 0), ((2, 197, 2, 128), 1)]
# ... timed in phase 3: DeiT-S's search-step shape as a view one element
# into its rows (so no body but this one takes it), the search grids' head
# dims 20 (of a 32-wide head) and 36 (of vit_small's 96) at 197 tokens and
# 20 at DeiT at 384 pixels, and the compression story's subnet (17 tokens,
# phase 15)
UNALIGNED_TIMING = [((256, 197, 6, 64), 1), ((256, 197, 6, 20), 0),
                    ((256, 197, 4, 36), 0), ((64, 577, 6, 20), 0),
                    ((128, 17, 2, 20), 0)]
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
BODIES = ("resident", "streaming", "unaligned", "general")
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


def check_kernels(A, cases=None):
    """Phase 2. Returns the max abs errors of the resident body at the
    search step's shape and type (DeiT-S, bf16), of the general body at
    that shape in fp32 (the type it serves), of the streaming body at
    DeiT-S at 384 pixels, batch 64, and of the unaligned body at the first
    shape of UNALIGNED_TIMING (by kernel name); and those of the unaligned
    body at every shape it was held at, by ((shape, offset), kernel name).
    `cases` ((shape, dtype, body[, offset]), ...) replaces phase 2's list
    (phase 13's head counts, phase 15's story shapes)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases_given = cases is not None
    if cases is None:
        bodies = ((torch.bfloat16, "unaligned"), (torch.float32, "general"))
        cases = [(shape, torch.bfloat16, "resident") for shape in RESIDENT]
        cases += [(shape, torch.bfloat16, "streaming")
                  for shape in STREAMING]
        cases += [(shape, dtype, body) for shape in GENERAL
                  for dtype, body in bodies]
        cases += [(shape, dtype, body, 1) for shape in GENERAL_UNALIGNED
                  for dtype, body in bodies]
        cases += [(shape, torch.bfloat16, "unaligned") + ((off,) if off else ())
                  for shape, off in UNALIGNED + UNALIGNED_TIMING]
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
        at = (shape, offset[0] if offset else 0)
        main = {"resident": (DEIT_S, 0), "streaming": (STREAMING[0], 0),
                "general": (DEIT_S, 0), "unaligned": UNALIGNED_TIMING[0]}
        tag = "" if body == "resident" else "_" + body
        for key in ((at,) if body == "unaligned" else ()) \
                + (() if cases_given or at != main[body] else (None,)):
            main_err[key, "attention_fwd" + tag] = fwd[0]
            main_err[key, "attention_bwd" + tag] = max(e[0] for e in bwd)
    return {k[1] if k[0] is None else k: e for k, e in main_err.items()}


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
    """Phase 3: ms of the resident and the unaligned bodies of each kernel,
    the twin and SDPA at batch 256, bf16, on this one card; the bodies in
    turns (unaligned, resident, resident, unaligned), each figure the mean
    of its two turns. The resident body must be faster than the unaligned
    one, or within twice its time (a guard that the choice of body holds:
    the unaligned body is built for the shapes the resident one cannot
    take, not to lose to it)."""
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
                 ("unaligned", "resident", "resident", "unaligned")]
        ms = {body: sum(t for b, t in turns if b == body) / 2
              for body in ("unaligned", "resident")}
        dev = {body: device_time_ms(lambda: call(body))
               for body in ("unaligned", "resident")}
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
        log(f"timing {name} B={B} bf16: turns " +
            ", ".join(f"{b} {t:.4f}" for b, t in turns) + f" ms; resident "
            f"{ms['resident']:.4f} ms is "
            f"{ms['unaligned'] / ms['resident']:.2f}x faster than unaligned "
            f"{ms['unaligned']:.4f} ms; plain "
            f"{shared['plain_ms']:.4f} ms, sdpa {shared['library_ms']:.4f} "
            f"ms, bound {shared['bound_ms']:.4f} ms ({shared['bound_by']}); "
            f"device time: resident {dev['resident']:.4f}, unaligned "
            f"{dev['unaligned']:.4f}, plain {shared['plain_device_ms']:.4f}, "
            f"sdpa {shared['library_device_ms']:.4f} ms")
        if ms["resident"] >= 2 * ms["unaligned"]:
            raise AssertionError(f"{name}: the resident body takes more than "
                                 f"twice the unaligned body's time")
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
    forward and backward, bf16, at batch 256 (the bench's): the resident
    and the unaligned bodies in turns (the unaligned one asked for by
    name), the plain twin and SDPA, beside the
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
            for b in ("resident", "unaligned"):
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
                         for b in ("unaligned", "resident", "resident",
                                   "unaligned")]
                for b in ("resident", "unaligned"):
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
                        for b in ("resident", "unaligned", "plain", "sdpa"))
                    + f", bound {row[n + '_bound_ms']:.4f}"
                    for n in ("fwd", "bwd")))
    return rows


def time_streaming(A):
    """Phase 3, continued: at each shape of STREAM_TIMING, bf16, the
    unaligned and the streaming bodies of each kernel in turns (unaligned,
    streaming, streaming, unaligned; each figure the mean of its two turns),
    the plain twin and SDPA, each also as device time, beside the bytes
    and the operations bounds; for the backward also the streaming design's
    own floor (it computes 14 B H N² d flops for the math's 10). Returns
    the rows and, at the first shape, the streaming kernels' JSON fields."""
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
        for b in ("streaming", "unaligned"):
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
                     for b in ("unaligned", "streaming", "streaming",
                               "unaligned")]
            for b in ("streaming", "unaligned"):
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
                for b in ("streaming", "unaligned", "plain", "sdpa"))
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
            if row[f"{n}_streaming_ms"] >= row[f"{n}_unaligned_ms"]:
                raise AssertionError(f"attention_{n} at {(B, N, H, d)}: the "
                                     f"streaming body is not faster than "
                                     f"the unaligned one")
            fields[f"attention_{n}_streaming"] = dict(
                shape=row["shape"], ms=row[f"{n}_streaming_ms"],
                device_ms=row[f"{n}_streaming_device_ms"],
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


def time_unaligned(A, shapes, errs, what="phase 3"):
    """Phase 3, continued (and phase 15 at the story's shapes): the
    unaligned body at each (shape, offset in elements) of `shapes`, bf16,
    by CUDA events and as device time, beside the plain twin, SDPA and the
    bound (bytes at the HBM rate, operations at the dense bf16 peak), with
    the kernels' max abs errors at the shape from `check_kernels`
    (`errs`). Returns the rows."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    for (B, N, H, d), off in shapes:
        q, k, v = make_qkv(B, N, H, d, torch.bfloat16, gen, off)
        do = torch.randn(q.shape, generator=gen,
                         device="cuda").to(torch.bfloat16)
        row = dict(shape=[B, N, H, d], offset=off, body="unaligned",
                   dtype="bfloat16")
        for n in ("fwd", "bwd"):
            row[f"{n}_max_abs_err"] = errs[((B, N, H, d), off),
                                          f"attention_{n}_unaligned"]
        _bounds(row, B, N, H, d, 2, BF16_FLOPS)
        _time_row(row, _attention_calls(A, q, k, v, do, "unaligned"),
                  f"{(B, N, H, d)} bf16{f' {off} element in' if off else ''}"
                  f", unaligned body ({what})")
        rows.append(row)
    return rows


# the shapes (and offsets) at which `time_body_worker` times each body
BODY_TIMING = {"resident": [(TIMING, 0)],
               "streaming": [(STREAM_TIMING[0], 0)]}


def time_body_worker(body, root=None):
    """`python3 chip_smoke.py --time-body BODY [ROOT]`: the forward and the
    backward of one attention body, bf16, at its shapes in BODY_TIMING (any
    other name at UNALIGNED_TIMING's), by CUDA events and as device time,
    beside SDPA and the bound, one JSON line a shape. With ROOT it loads
    `ofb_tpu_torch` from that checkout (an older commit unpacked beside this
    one, where `general` is the bf16 body that `unaligned` replaced), so
    that two versions of a body are timed on one card: run them in turns
    (old, new, new, old), a process each."""
    import torch
    sys.path.insert(0, os.path.abspath(root) if root else
                    os.path.dirname(os.path.abspath(__file__)))
    from ofb_tpu_torch.ops import attention as A
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke --time-body: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(15)
    for (B, N, H, d), off in BODY_TIMING.get(body, UNALIGNED_TIMING):
        q, k, v = make_qkv(B, N, H, d, torch.bfloat16, gen, off)
        do = torch.randn(q.shape, generator=gen,
                         device="cuda").to(torch.bfloat16)
        row = dict(root=os.path.abspath(A.__file__), body=body,
                   shape=[B, N, H, d], offset=off)
        _bounds(row, B, N, H, d, 2, BF16_FLOPS)
        calls = _attention_calls(A, q, k, v, do, body)
        for key in ("fwd_kernel", "bwd_kernel", "fwd_sdpa", "bwd_sdpa"):
            row[key + "_ms"] = cuda_time_ms(calls[key])
            row[key + "_device_ms"] = device_time_ms(calls[key])
        print(json.dumps(row), flush=True)


def _kernel_fields(row, n):
    """One kernel's fields (n: "fwd" or "bwd") of a `_time_row` row, under
    the names of the kernels' JSON line."""
    names = {"kernel_ms": "ms", "kernel_device_ms": "device_ms",
             "sdpa_ms": "library_ms", "sdpa_device_ms": "library_device_ms"}
    out = {k: row[k] for k in ("shape", "offset") if k in row}
    for k, v in row.items():
        if k.startswith(n + "_"):
            out[names.get(k[len(n) + 1:], k[len(n) + 1:])] = v
    return out


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
VIT_IMAGES = 512
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
    body VIT_SHAPES names, none on the unaligned or the general body.
    Returns the launches
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
    if any(n for k, n in totals.items()
           if k.endswith("_general") or k.endswith("_unaligned")):
        raise AssertionError(f"a bf16 run of phase 10 launched the unaligned "
                             f"or the general body: {totals}")
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
# the window-attention pair timed at Swin-T's stages, batch 256, head dim
# 32: (tokens a side, heads, blocks of the stage)
SWIN_WINDOW_TIMING = ((56, 3, 2), (28, 6, 2), (14, 12, 6), (7, 24, 2))
SWIN_WINDOW_BATCH = 256
# the window kernels' largest error against their plain versions, as a
# share of the plain version's largest magnitude (the card tests'): bf16
# outputs round once more or less than the plain version's
WINDOW_TOL = {"out": 1e-2, "lse": 1e-5, "dqkv": 1e-2, "dtable": 1e-3}


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
    to the widths their model_exported/meta.json records; (f) the
    window-attention pair held to its plain version and timed
    (`time_window_attention`). Swin's window
    attention runs on its own kernels: no attention kernel of the ViT
    bodies may launch, and the window kernels must have (fp32 in (a),
    bf16 after). Returns (the attention launches counted (all 0), the
    window kernels' launches and timing)."""
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
    from ofb_tpu_torch.ops import window_attention as W

    # every body of both wrappers, at 0
    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)

    def add(counts):
        for k, n in kernel_counts(counts).items():
            totals[k] += n
    A.reset_launch_counts()
    W.reset_launch_counts()
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
    per = {k: n for k, n in pstep.launches_per_replay.items()
           if k[0].startswith("window_attention") and n}
    blocks = sum(bundle.cfg.depths) * scfg.accum_iter
    if per != {("window_attention_fwd", "bf16"): blocks,
               ("window_attention_bwd", "bf16"): blocks}:
        raise AssertionError(f"swin planned step: window-attention launches "
                             f"a replay {per}, wanted {blocks} + {blocks}")
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
                             "its window attention has its own kernels")
    window = {f"{w}/{k}": n for (w, k), n in W.launch_counts().items()}
    if not all(window.values()):
        raise AssertionError(f"swin: window-attention launches {window}: "
                             "every kind should have run")
    log(f"swin: attention launches over the phase {totals} (none expected), "
        f"window-attention launches {window}")
    return totals, dict(launches=window, timing=time_window_attention(W))


def time_window_attention(W):
    """Phase 11 (f): at SWIN_WINDOW_TIMING, bf16, the window-attention
    kernels held to their plain versions (`window_attention_fwd_reference`
    / `_bwd_reference`, run on the card on the same tensors: out, lse,
    dqkv and the table's gradient within WINDOW_TOL of the plain version's
    largest magnitude, or it raises), then their device time (forward;
    backward with its two bias-gradient passes; `queued_time_ms`, CUDA
    events over calls queued back to back: this late in the run the
    profiler loses kernel records) beside their bound
    (`benchmark/window_flops.py`'s: 8 bytes an element of q and 4 B H N² d
    FLOPs forward, 16 and 10 backward), the plain versions, the eager chain
    they replaced (`models.swin.window_softmax_chain` with autograd) and,
    as a yardstick, torch's scaled_dot_product_attention on its
    memory-efficient backend with the gathered bias plus the mask as one
    additive (nW H, N, N) `attn_mask` broadcast over the images (its
    q, k, v laid out as (B, nW H, N, d) before the clock, which the packed
    qkv would need a copy for; its gradient reaches the bias table through
    the gather). Peak memory above the inputs of one forward and backward
    of the pair, SDPA and the chain beside. Returns a row a stage and the
    sums over one microbatch's 12 blocks."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from ofb_tpu_torch.models import swin as S
    dev, w, d = torch.device("cuda"), 7, 32
    N, rows = w * w, []
    idx = S._rel_index(w, dev)
    for res, heads, blocks in SWIN_WINDOW_TIMING:
        g = torch.Generator(device=dev).manual_seed(res)
        nW = (res // w) ** 2
        mask = S._shift_mask(res, w, dev) if res > w else None
        Bw = SWIN_WINDOW_BATCH * nW
        qkv = torch.randn((Bw, N, 3 * heads * d), generator=g,
                          device=dev).to(torch.bfloat16)
        dout = torch.randn((Bw, N, heads * d), generator=g,
                           device=dev).to(torch.bfloat16)
        rb = 0.02 * torch.randn(((2 * w - 1) ** 2, heads), generator=g,
                                device=dev)
        sc = d ** -0.5
        out, lse = W.window_attention_fwd(qkv, heads, sc, rb, idx, mask)
        dqkv, dtable = W.window_attention_bwd(qkv, out, dout, lse, heads, sc,
                                              rb, idx, mask)
        want_f = W.window_attention_fwd_reference(qkv, heads, sc, rb, idx,
                                                  mask)
        want = want_f + W.window_attention_bwd_reference(
            qkv, want_f[0], dout, want_f[1], heads, sc, rb, idx, mask)
        err, rel = {}, {}
        for name, got, ref in zip(WINDOW_TOL, (out, lse, dqkv, dtable), want):
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"window attention {name} at {Bw} x "
                                     f"{heads}: shape {tuple(got.shape)} "
                                     f"(want {tuple(ref.shape)}) or not "
                                     "finite")
            err[name] = (got.float() - ref.float()).abs().max().item()
            rel[name] = _rel(got, ref)
        bad = {k: v for k, v in rel.items() if not v < WINDOW_TOL[k]}
        if bad:
            raise AssertionError(f"window attention at {Bw} x {heads} "
                                 f"(mask {mask is not None}) against its "
                                 f"plain version: {bad} (tol {WINDOW_TOL})")
        del want_f, want, dqkv, dtable
        qr, br = qkv.detach().requires_grad_(), rb.detach().requires_grad_()

        def chain():
            return S.window_softmax_chain(qr, heads, sc, br, idx, mask)
        y = chain()
        # the yardstick: SDPA over (B, nW H, N, d), one additive bias
        lay = [t.reshape(SWIN_WINDOW_BATCH, nW, N, heads, d).transpose(
            2, 3).reshape(SWIN_WINDOW_BATCH, nW * heads, N, d).contiguous()
            .requires_grad_() for t in qkv.unflatten(-1, (3, -1)).unbind(2)]
        sb = rb.detach().requires_grad_()
        sdo = dout.reshape(SWIN_WINDOW_BATCH, nW, N, heads, d).transpose(
            2, 3).reshape(SWIN_WINDOW_BATCH, nW * heads, N, d).contiguous()

        def sdpa():
            bias = sb[idx.reshape(-1)].reshape(N, N, heads).permute(2, 0, 1)
            bias = bias[None] if mask is None else bias[None] + \
                mask[:, None]
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(
                    *lay, attn_mask=bias.to(torch.bfloat16).contiguous()
                    .reshape(1, -1, N, N), scale=sc)
        so = sdpa()
        so_err = _rel(so.reshape(SWIN_WINDOW_BATCH, nW, heads, N, d)
                      .transpose(2, 3).reshape(Bw, N, heads * d), out)
        calls = {
            "fwd": (lambda: W.window_attention_fwd(
                qkv, heads, sc, rb, idx, mask), 20),
            "bwd": (lambda: W.window_attention_bwd(
                qkv, out, dout, lse, heads, sc, rb, idx, mask), 20),
            "plain_fwd": (lambda: W.window_attention_fwd_reference(
                qkv, heads, sc, rb, idx, mask), 5),
            "plain_bwd": (lambda: W.window_attention_bwd_reference(
                qkv, out, dout, lse, heads, sc, rb, idx, mask), 5),
            "chain_fwd": (chain, 5),
            "chain_bwd": (lambda: torch.autograd.grad(
                y, (qr, br), dout, retain_graph=True), 5),
            "sdpa_fwd": (sdpa, 10),
            "sdpa_bwd": (lambda: torch.autograd.grad(
                so, (*lay, sb), sdo, retain_graph=True), 10)}
        ms = {}
        for k, (fn, iters) in calls.items():
            fn()                                 # warm
            ms[k] = queued_time_ms(fn, iters)

        def pair():
            o, m = W.window_attention_fwd(qkv, heads, sc, rb, idx, mask)
            return W.window_attention_bwd(qkv, o, dout, m, heads, sc, rb,
                                          idx, mask)
        peak = {}
        for k, step in (
                ("kernels", pair),
                ("chain", lambda: torch.autograd.grad(chain(), (qr, br),
                                                      dout)),
                ("sdpa", lambda: torch.autograd.grad(sdpa(), (*lay, sb),
                                                     sdo))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            step()
            torch.cuda.synchronize()
            peak[k] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        n = Bw * N * heads * d
        flops = 4.0 * Bw * heads * N * N * d
        bound = {"fwd": 1e3 * max(8 * n / HBM_BYTES_PER_S, flops / BF16_FLOPS),
                 "bwd": 1e3 * max(16 * n / HBM_BYTES_PER_S,
                                  2.5 * flops / BF16_FLOPS)}
        row = dict(shape=[Bw, N, heads, d], mask=mask is not None,
                   blocks=blocks, max_abs_err=err, rel_err=rel,
                   sdpa_out_rel_err=so_err, ms=ms, peak_mib=peak,
                   bound_ms=bound,
                   bound_share={k: bound[k] / ms[k] for k in bound})
        rows.append(row)
        log(f"11 window attention {tuple(row['shape'])} mask {row['mask']}: "
            f"against the plain version {rel} of its largest (max abs "
            f"{err}); kernel fwd {ms['fwd']:.4f} / bwd {ms['bwd']:.4f} ms "
            f"(bound {bound['fwd']:.4f} / {bound['bwd']:.4f}: "
            f"{100 * bound['fwd'] / ms['fwd']:.1f}% / "
            f"{100 * bound['bwd'] / ms['bwd']:.1f}%), plain version "
            f"{ms['plain_fwd']:.4f} / {ms['plain_bwd']:.4f}, eager chain "
            f"{ms['chain_fwd']:.4f} / {ms['chain_bwd']:.4f}, sdpa "
            f"{ms['sdpa_fwd']:.4f} / {ms['sdpa_bwd']:.4f} (out {so_err:.2e} "
            f"off the kernel's); peak MiB above the inputs {peak}")
        del qkv, dout, out, lse, qr, br, y, lay, sb, sdo, so
        torch.cuda.empty_cache()
    per = {k: sum(r["blocks"] * r["ms"][k] for r in rows)
           for k in rows[0]["ms"]}
    per["bound"] = sum(r["blocks"] * (r["bound_ms"]["fwd"]
                                      + r["bound_ms"]["bwd"]) for r in rows)
    log(f"11 window attention a microbatch of {SWIN_WINDOW_BATCH}: kernels "
        f"{per['fwd']:.2f} + {per['bwd']:.2f} ms (bound {per['bound']:.2f}: "
        f"{100 * per['bound'] / (per['fwd'] + per['bwd']):.1f}%), plain "
        f"versions {per['plain_fwd']:.2f} + {per['plain_bwd']:.2f}, eager "
        f"chain {per['chain_fwd']:.2f} + {per['chain_bwd']:.2f}, sdpa "
        f"{per['sdpa_fwd']:.2f} + {per['sdpa_bwd']:.2f}")
    return dict(rows=rows, microbatch_ms=per)


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


def _finish(procs, what, timeout=None):
    """Wait for every process (`timeout` seconds in all, DIST_TIMEOUT by
    default); a timeout or a non-zero exit ends them all and fails the
    phase. Returns their stdouts."""
    import signal
    outs = []
    deadline = time.perf_counter() + (timeout or DIST_TIMEOUT)
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(deadline - time.perf_counter(), 1.0))
            sys.stderr.write(err[-4000:])
            if p.returncode != 0:
                raise AssertionError(f"{what}: a process exited "
                                     f"{p.returncode}:\n{out[-3000:]}\n"
                                     f"{err[-3000:]}")
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


# ---------------------------------------------------------------------------
# phase 13: the tensor-parallel search step, the dry run, per-block remat
# ---------------------------------------------------------------------------

TP_BATCH = 32              # the global batch of 13 (a) and (b)
TP_SEED = 13               # weights and images of 13 (a) and (b)
TP_GEN = 22                # the generator of their PMIM masks
TP_MESHES = (2, 4)         # model axes of 13 (a) and (b): heads 3 + 3,
                           # and 2 + 2 + 1 + 1
TP_RESUME_WAIT = 300       # seconds a rank of 13 (b) waits for (a)'s file
# the resident pair at a rank's share of DeiT-S's six heads
TP_HEADS = [(TP_BATCH, 197, 3, 64), (TP_BATCH, 197, 2, 64),
            (TP_BATCH, 197, 1, 64)]
# the sharded step against one process's on the same card, bf16 (the
# row-parallel products are summed from bf16 partials in another order,
# through 12 blocks): the loss of both steps and the weights' gradient norm
# relative to one process's; each watched leaf's update (every weight and
# bias of qkv, proj, fc1 and fc2, the alphas) of the same sign but for at
# most TOL_TP_FLIPS of its elements (Adam's first update is lr * sign(g),
# so a gradient that bf16 rounding moves across 0 flips its element's
# update), and the norm of the updates' difference relative to the update's
# within TOL_TP_REL (a flipped element adds 2 lr: 2 sqrt(flips) a step);
# a qkv bias's k third is left out of both (`_update_view`); the export's
# tensors within TOL_TP_EXPORT of one process's export (the warm-up's
# learning rate moves a weight by ~1e-6 a step, a flipped update by twice
# that)
TOL_TP_LOSS = 1e-3
TOL_TP_GRAD_NORM = 1e-2
TOL_TP_FLIPS = 0.02
TOL_TP_REL = 0.4
TOL_TP_EXPORT = 2e-5
TP_WATCHED = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
              "attn.proj.bias", "mlp.fc1.weight", "mlp.fc1.bias",
              "mlp.fc2.weight", "mlp.fc2.bias")
REMAT_BATCH = 256
REMAT_MODELS = ("deit_small", "deit_base")
REMAT_CALLS = 2            # timed steps a turn (after one untimed)


def _tp_watched(state, layout):
    """The gathered watched leaves (TP_WATCHED, the alphas) of a state,
    on the host."""
    from ofb_tpu_torch.core.optim import named_leaves
    from ofb_tpu_torch.parallel.mesh import gather_named
    live = {n: p.detach() for n, p in
            named_leaves(state.params, state.alphas).items()
            if n.startswith("alphas.") or n.endswith(TP_WATCHED)}
    return {n: t.to("cpu", copy=True)
            for n, t in gather_named(live, layout).items()}


def _tp_build(mesh, seed):
    """(bundle, search config, state, step) of 13's DeiT-S supernet from
    `seed`, sharded on `mesh`'s model axis (whole without a mesh)."""
    import torch
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.core.optim import named_leaves
    from ofb_tpu_torch.core.steps import TrainState, make_search_step
    from ofb_tpu_torch.models.registry import create_model
    from ofb_tpu_torch.parallel.mesh import shard_params
    bundle = create_model("deit_small_patch16_224_mim", device="cuda",
                          patch_search=True)
    params, alphas, arch = bundle.init(seed)
    if mesh is not None:
        shard_params(params, mesh)
    scfg, tx = B.search_config(TP_BATCH)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(named_leaves(params, alphas)))
    step = make_search_step(bundle.space, bundle.cfg, scfg, tx,
                            compute_dtype=torch.bfloat16, device="cuda")
    return bundle, scfg, state, step


def tp_resume(path, mesh, images, labels):
    """The post-prune step resumed from the checkpoint at `path`: a fresh
    DeiT-S supernet (other weights) sharded on `mesh` (whole without
    one), the checkpoint restored into it (params, alphas, arch, Adam's
    state) and the PMIM generator set to the state its meta holds, then
    the step. Returns (metrics, the watched leaves after it, seconds of the
    restore, ms of the step, its attention launches)."""
    import torch
    from ofb_tpu_torch.core.checkpoint import load_checkpoint
    from ofb_tpu_torch.ops import attention as A
    from ofb_tpu_torch.parallel.mesh import tp_of
    _, _, state, step = _tp_build(mesh, TP_SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = load_checkpoint(path, params=state.params, alphas=state.alphas,
                           arch=state.arch,
                           opt_state=state.opt_state)["meta"]
    state.step.fill_(meta["step"])
    g = torch.Generator(device="cuda")
    g.set_state(torch.tensor(meta["generator"], dtype=torch.uint8))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    before = kernel_counts(by_body(A))
    t0 = time.perf_counter()
    _, m = step(state, images, labels, g, 0.75)
    m = _finite(m, "13 resumed step")
    ms = (time.perf_counter() - t0) * 1e3
    after = kernel_counts(by_body(A))
    counts = {k: after[k] - before[k] for k in after}
    return m, _tp_watched(state, tp_of(state.params)), restore_s, ms, counts


def tp_sequence(mesh, out=None, cross=None):
    """13 (a) / (b) in one rank (`mesh` a (1, tp) mesh) or in one process
    (mesh None): DeiT-S bf16 from TP_SEED, sharded on the mesh's model
    axis; a search step on the global batch of TP_BATCH, block 0's MLP
    alpha cell 0 at -8 and a compress pass, then on a mesh the state
    saved to `out`/resume (every rank calls it, rank 0 writes; the PMIM
    generator's state in its meta), a post-prune step, on a mesh the same
    step resumed from that file (`tp_resume`), then a forced convergence
    and the export (gathered first on a mesh). With `cross` the post-prune
    step resumed from that checkpoint of another mesh too, once its
    meta.json is there. Rank 0 (and one process) writes the watched leaves
    (TP_WATCHED, the alphas) after each step, the resumed ones and the
    export to `out`/tp.pt. Returns the JSON-able summary (`peak_mib`: the
    uninterrupted steps' peak over what the process held before the model
    was built; `counts`: every attention launch of the sequence); without
    a mesh also the watched leaves, at the start too, and the export."""
    import torch
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.core.checkpoint import commit_saves, save_checkpoint
    from ofb_tpu_torch.core.compress import compress
    from ofb_tpu_torch.core.export import export_subnet
    from ofb_tpu_torch.ops import attention as A
    from ofb_tpu_torch.parallel.distributed import rank_world
    from ofb_tpu_torch.parallel.mesh import tp_of

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    bundle, scfg, state, step = _tp_build(mesh, TP_SEED)
    alphas = state.alphas
    images, labels = B.random_batch(bundle.cfg, TP_BATCH, "cuda", TP_SEED)
    g = torch.Generator(device="cuda").manual_seed(TP_GEN)
    layout = tp_of(state.params)
    metrics, times, snaps, res = [], [], {}, {}

    def one_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, images, labels, g, 0.75)
        metrics.append(_finite(m, "13 tensor-parallel step"))
        times.append((time.perf_counter() - t0) * 1e3)

    def resumed(tag, path):
        m, snaps[tag], restore_s, ms, counts = tp_resume(path, mesh, images,
                                                         labels)
        res[tag] = {"metrics": m, "restore_s": restore_s, "step_ms": ms,
                    "counts": counts}

    if mesh is None:
        snaps["init"] = _tp_watched(state, layout)
    A.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one_step()
    snaps["step1"] = _tp_watched(state, layout)
    with torch.no_grad():
        alphas.blocks[0].mlp[..., 0] = -8.0
    report = compress(state.params, alphas, state.arch, state.opt_state,
                      bundle.space, scfg.compress_thresh)[4]
    if not report.execute_prune:
        raise AssertionError("13: the forced compress event did not fire")
    if mesh is not None:
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(out, "resume"), params=state.params,
                        alphas=alphas, arch=state.arch,
                        opt_state=state.opt_state,
                        meta={"step": int(state.step),
                              "generator": g.get_state().tolist()})
        commit_saves("13 resume point")
        res["save_s"] = time.perf_counter() - t0
    one_step()
    snaps["step2"] = _tp_watched(state, layout)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
    if mesh is not None:
        resumed("resumed", os.path.join(out, "resume"))
    if cross is not None:
        deadline = time.perf_counter() + TP_RESUME_WAIT
        while not os.path.exists(os.path.join(cross, "meta.json")):
            if time.perf_counter() > deadline:
                raise AssertionError(f"13: no checkpoint at {cross} after "
                                     f"{TP_RESUME_WAIT} s")
            time.sleep(0.5)
        resumed("cross", cross)
    counts = by_body(A)
    conv = B.force_convergence(state, bundle.space)[0]
    if not conv.finish_search:
        raise AssertionError(f"13: no convergence: {conv.events}")
    dense, dcfg, _ = export_subnet(state.params, state.arch, bundle.space,
                                   bundle.cfg)
    export = {n: p.detach().cpu() for n, p in dense.named_parameters()}
    if out is not None and rank_world()[0] == 0:
        torch.save({"snaps": snaps, "export": export},
                   os.path.join(out, "tp.pt"))
    res.update(metrics=metrics, step_ms=times, peak_mib=peak, counts=counts,
               events=report.events,
               block_dims=[list(b) for b in dcfg.block_overrides])
    if mesh is None:
        res.update(snaps=snaps, export=export)
    return res


def tp_worker(rank, world, rdzv, out, cross=None):
    """13 (a) / (b), one of `world` ranks sharing the card over gloo on a
    (1, world) mesh: `tp_sequence` (with `cross`, also the post-prune step
    resumed from that checkpoint of another mesh). Prints `TP_STEP
    {json}`."""
    _worker_setup()
    import torch.distributed as dist
    from ofb_tpu_torch.parallel import distributed as D
    from ofb_tpu_torch.parallel.mesh import make_mesh
    if D.init_distributed("gloo", init_method=f"file://{rdzv}") != (
            rank, world):
        raise AssertionError(f"13: not a world of {world}")
    mesh = make_mesh((1, world))
    res = tp_sequence(mesh, out, cross)
    D.barrier_sync("13 done")
    dist.destroy_process_group()
    res.update(rank=rank, world=world)
    print("TP_STEP " + json.dumps(res), flush=True)


def _tp_resumed_close(what, got_m, want_m, got, want, init):
    """A post-prune step resumed from another mesh's checkpoint against the
    uninterrupted one of `what`: the loss and the grad norm within
    TOL_TP_LOSS / TOL_TP_GRAD_NORM of it, the watched leaves' updates since
    `init` within TOL_TP_FLIPS / TOL_TP_REL (as 13 (a) / (b) hold a mesh
    against one process); returns the summary."""
    loss, gnorm = (abs(got_m[k] - want_m[k]) / abs(want_m[k])
                   for k in ("loss_total", "grad_norm"))
    flips, rels = (0.0, "none"), (0.0, "none")
    for n, w in want.items():
        f, r = _flip_share(*(_update_view(n, t) for t in (got[n], w,
                                                          init[n])))
        flips, rels = max(flips, (f, n)), max(rels, (r, n))
    if loss > TOL_TP_LOSS or gnorm > TOL_TP_GRAD_NORM \
            or flips[0] > TOL_TP_FLIPS or rels[0] > TOL_TP_REL:
        raise AssertionError(
            f"13 resume across meshes, {what}: loss rel {loss:.3e} (tol "
            f"{TOL_TP_LOSS:g}), grad norm rel {gnorm:.3e} (tol "
            f"{TOL_TP_GRAD_NORM:g}), update signs flipped at {flips[0]:.4f} "
            f"of {flips[1]} (tol {TOL_TP_FLIPS:g}), update difference rel "
            f"{rels[0]:.3e} at {rels[1]} (tol {TOL_TP_REL:g})")
    return (f"{what}: loss rel {loss:.3e}, grad norm rel {gnorm:.3e}, "
            f"update signs flipped at most {flips[0]:.4f} ({flips[1]}), "
            f"update difference rel at most {rels[0]:.3e} ({rels[1]})")


def _update_view(name, t):
    """The elements of a watched leaf whose update 13 (a) / (b) compare: a
    qkv bias without its k third, whose gradient is zero but for rounding
    (a shift of every key by b_k moves a query's scores by the one number
    q . b_k, which the softmax ignores), so its update is the sign of
    noise."""
    if not name.endswith("attn.qkv.bias"):
        return t
    d = t.shape[-1] // 3
    import torch
    return torch.cat([t[..., :d], t[..., 2 * d:]], -1)


def _flip_share(got, want, init):
    """The share of elements whose update has the other sign, and the
    relative norm of the updates' difference."""
    du, dw = got - init, want - init
    flips = ((du.sign() != dw.sign()) & (dw != 0)).float().mean().item()
    return flips, ((du - dw).norm() / dw.norm().clamp_min(1e-30)).item()


def run_remat(A, card):
    """13 (c): the search step with `remat` against the plain step, DeiT-S
    and DeiT-B at REMAT_BATCH, from one seed: the state after one step
    equal (ArchState bit-identical, every other tensor within TOL_GRAPH),
    then ms a step in turns (plain, remat, remat, plain; REMAT_CALLS
    timed steps a turn, host time) and the peak device memory of a step
    over what was resident before it. Returns the launches."""
    import torch
    from ofb_tpu_torch import bench as B
    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)
    for model in REMAT_MODELS:
        runs = {}
        for remat in (False, True):
            bundle, state, step, images, labels = B.build_step(
                model, REMAT_BATCH, seed=31, remat=remat)
            runs[remat] = {"state": state, "step": step, "images": images,
                           "labels": labels,
                           "gen": torch.Generator(device="cuda")
                           .manual_seed(32), "ms": [], "mib": []}

        def call(r):
            r["state"], m = r["step"](r["state"], r["images"], r["labels"],
                                      r["gen"], 0.75)
            return m["loss_total"]

        A.reset_launch_counts()
        for r in runs.values():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call(r)
            torch.cuda.synchronize()
            r["mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            r["peak"] = torch.cuda.max_memory_allocated() / 2 ** 20
        worst = _state_diff(f"13 (c) {model}", runs[True]["state"],
                            runs[False]["state"])
        for remat in (False, True, True, False):
            r = runs[remat]
            _, dt = _timed_calls(lambda: call(r), REMAT_CALLS)
            r["ms"].append(dt * 1e3)
        for k, n in kernel_counts(by_body(A)).items():
            totals[k] += n
        plain, rem = runs[False], runs[True]
        log(f"remat (c) {model} search step, batch {REMAT_BATCH}, on {card}:"
            f" remat = plain after one step (largest difference "
            f"{worst[0]:.3e} at {worst[1]}, tol {TOL_GRAPH:g}); ms a step "
            f"plain {[round(t, 2) for t in plain['ms']]}, remat "
            f"{[round(t, 2) for t in rem['ms']]} (host time, {REMAT_CALLS} "
            f"steps a turn); a step's peak over resident memory plain "
            f"{plain['mib']:.1f} MiB, remat {rem['mib']:.1f} MiB (both "
            f"states resident: peak {plain['peak']:.1f} / "
            f"{rem['peak']:.1f} MiB)")
        del runs
        torch.cuda.empty_cache()
    return totals


def run_tp(A, card, root):
    """Phase 13: (a) the tensor-parallel search step on a (1, 2) mesh and
    (b) on a (1, 4) mesh, ranks sharing the card over gloo (correctness
    runs, not speed figures: gloo stages card tensors through the host),
    against one process's sequence on the card, each resuming its own
    checkpoint, (b) and one process also (a)'s; the resident pair at a
    rank's head counts against its twin; (c) remat against the plain step;
    (d) `python -m ofb_tpu_torch.dryrun --devices 4 --tiny` on the card.
    Returns the launches of (a) to (c) and of the resumed steps."""
    import numpy as np
    import torch

    torch.cuda.empty_cache()
    me = os.path.abspath(__file__)
    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)
    t0 = time.perf_counter()
    dirs, procs = {}, []
    for tp in TP_MESHES:
        dirs[tp] = tempfile.mkdtemp(prefix=f"ofb_tp{tp}_", dir=root)
    # (b)'s ranks and the one process also resume (a)'s checkpoint
    cross = os.path.join(dirs[TP_MESHES[0]], "resume")
    for tp in TP_MESHES:
        procs += [_start([sys.executable, me, "--tp-step", str(r), str(tp),
                          os.path.join(dirs[tp], "rdzv"), dirs[tp]]
                         + ([cross] if tp != TP_MESHES[0] else []),
                         _dist_env(r, tp)) for r in range(tp)]
    dry = _start([sys.executable, "-m", "ofb_tpu_torch.dryrun", "--devices",
                  "4", "--tiny", "--device", "cuda"], _dist_env())
    # meanwhile: the resident pair at a rank's share of the heads (not
    # counted: a comparison)
    check_kernels(A, [(s, torch.bfloat16, "resident") for s in TP_HEADS])
    outs = _finish(procs + [dry], "13 (a), (b), (d)")
    workers_s = time.perf_counter() - t0
    ranks = {}
    for out in outs[:-1]:
        r = _tagged(out, "TP_STEP")
        ranks.setdefault(r["world"], []).append(r)
    done = [ln for ln in outs[-1].splitlines()
            if ln.startswith("dryrun_multichip(4): tiny mesh=(2x2) ")
            and ln.endswith(" OK")]
    if len(done) != 1 or "compress digest: " not in outs[-1]:
        raise AssertionError(f"13 (d): the dry run's output:\n"
                             f"{outs[-1][-2000:]}")
    log(f"tp (d) python -m ofb_tpu_torch.dryrun --devices 4 --tiny --device "
        f"cuda: {done[0]}")

    # the same sequence in one process on the card, then (a)'s checkpoint
    # resumed in it: only that step's launches count
    A.reset_launch_counts()
    one = tp_sequence(None, cross=cross)
    A.reset_launch_counts()
    step12 = kernel_counts(only("resident", 12, 12))
    if one["cross"]["counts"] != step12:
        raise AssertionError(f"13: one process's resumed step launched "
                             f"{one['cross']['counts']}")
    for k, n in one["cross"]["counts"].items():
        totals[k] += n
    want = one["snaps"]
    init = want["init"]
    crossed = [_tp_resumed_close("one process", one["cross"]["metrics"],
                                 one["metrics"][1], want["cross"],
                                 want["step2"], init)]
    for tp, rs in sorted(ranks.items()):
        rs.sort(key=lambda r: r["rank"])
        # two steps and the resumed one, and on (b) (a)'s checkpoint resumed
        resumes = ("resumed", "cross") if tp != TP_MESHES[0] \
            else ("resumed",)
        for r in rs:
            if r["metrics"] != rs[0]["metrics"] \
                    or r["events"] != rs[0]["events"]:
                raise AssertionError(f"13 tp {tp}: rank {r['rank']} differs "
                                     f"from rank 0")
            n_steps = 2 + len(resumes)
            if r["counts"] != only("resident", 12 * n_steps, 12 * n_steps) \
                    or any(r[k]["counts"] != step12 for k in resumes):
                raise AssertionError(f"13 tp {tp} rank {r['rank']}: launches "
                                     f"{r['counts']}, resumed "
                                     f"{[r[k]['counts'] for k in resumes]}")
            # the resumed step on the same mesh is the uninterrupted one,
            # bit for bit (every kernel of the step is deterministic: the
            # resident backward sums without atomics)
            if r["resumed"]["metrics"] != r["metrics"][1]:
                raise AssertionError(
                    f"13 tp {tp} rank {r['rank']}: the resumed step's metrics "
                    f"{r['resumed']['metrics']} are not the uninterrupted "
                    f"step's {r['metrics'][1]}")
            for k, n in kernel_counts(r["counts"]).items():
                totals[k] += n
        if rs[0]["events"] != one["events"] \
                or rs[0]["block_dims"] != one["block_dims"]:
            raise AssertionError(f"13 tp {tp}: compress events "
                                 f"{rs[0]['events']} / {one['events']}, "
                                 f"export widths {rs[0]['block_dims']} / "
                                 f"{one['block_dims']}")

        def rel_to_one(key):
            return [abs(a[key] - b[key]) / abs(b[key])
                    for a, b in zip(rs[0]["metrics"], one["metrics"])]

        loss, gnorm = rel_to_one("loss_total"), rel_to_one("grad_norm")
        saved = torch.load(os.path.join(dirs[tp], "tp.pt"))
        if set(saved["snaps"]["step1"]) != set(want["step1"]):
            raise AssertionError(f"13 tp {tp}: watched leaves differ")
        for n, w in saved["snaps"]["step2"].items():
            if not torch.equal(saved["snaps"]["resumed"][n], w):
                d = (saved["snaps"]["resumed"][n] - w).abs().max().item()
                raise AssertionError(f"13 tp {tp}: the resumed step's {n} "
                                     f"differs from the uninterrupted step's "
                                     f"by {d:.3e}")
        if "cross" in resumes:
            crossed.append(_tp_resumed_close(
                f"mesh (1, {tp})", rs[0]["cross"]["metrics"],
                rs[0]["metrics"][1], saved["snaps"]["cross"],
                saved["snaps"]["step2"], init))
        flips, rels = (0.0, "none"), (0.0, "none")
        for tag in ("step1", "step2"):
            for n, w in want[tag].items():
                f, r = _flip_share(
                    *(_update_view(n, t) for t in (saved["snaps"][tag][n], w,
                                                   init[n])))
                flips = max(flips, (f, f"{tag} {n}"))
                rels = max(rels, (r, f"{tag} {n}"))
        ex, ex_at = 0.0, "none"
        if set(saved["export"]) != set(one["export"]):
            raise AssertionError(f"13 tp {tp}: the export's tensors differ")
        for n, w in one["export"].items():
            got = saved["export"][n]
            if got.shape != w.shape:
                raise AssertionError(f"13 tp {tp}: export {n} {got.shape} "
                                     f"!= {w.shape}")
            d = (got.float() - w.float()).abs().max().item()
            if d >= ex:
                ex, ex_at = d, n
        if max(loss) > TOL_TP_LOSS or max(gnorm) > TOL_TP_GRAD_NORM \
                or flips[0] > TOL_TP_FLIPS or rels[0] > TOL_TP_REL \
                or ex > TOL_TP_EXPORT:
            raise AssertionError(
                f"13 tp {tp}: loss rel {loss} (tol {TOL_TP_LOSS:g}), grad "
                f"norm rel {gnorm} (tol {TOL_TP_GRAD_NORM:g}), update signs "
                f"flipped at {flips[0]:.4f} of {flips[1]} (tol "
                f"{TOL_TP_FLIPS:g}), update difference rel {rels[0]:.3e} at "
                f"{rels[1]} (tol {TOL_TP_REL:g}), export off by {ex:.3e} at "
                f"{ex_at} (tol {TOL_TP_EXPORT:g})")
        log(f"tp ({'a' if tp == 2 else 'b'}) mesh (1, {tp}) over gloo on "
            f"{card} (a correctness run, not a speed figure), DeiT-S bf16, "
            f"batch {TP_BATCH}, heads by rank "
            f"{[len(a) for a in np.array_split(np.arange(6), tp)]}: search "
            f"step, forced compress ({'; '.join(rs[0]['events'])}), "
            f"post-prune step; rel to one process: loss {loss} (tol "
            f"{TOL_TP_LOSS:g}), grad norm {gnorm} (tol "
            f"{TOL_TP_GRAD_NORM:g}); watched leaves' updates (qkv, proj, "
            f"fc1, fc2 weights and biases but a qkv bias's k third, alphas) "
            f"of the other sign at most "
            f"{flips[0]:.4f} ({flips[1]}; tol {TOL_TP_FLIPS:g}), update "
            f"difference rel at most {rels[0]:.3e} ({rels[1]}; tol "
            f"{TOL_TP_REL:g}); export (block dims {rs[0]['block_dims']}, "
            f"one process's) within {ex:.3e} ({ex_at}; tol "
            f"{TOL_TP_EXPORT:g}) of one process's export; peak "
            f"memory over what was held before the model, by rank "
            f"{[round(r['peak_mib'], 1) for r in rs]} MiB, one process "
            f"{one['peak_mib']:.1f} MiB; ms a step by rank "
            f"{[[round(t, 1) for t in r['step_ms']] for r in rs]}, one "
            f"process {[round(t, 1) for t in one['step_ms']]}; launches a "
            f"rank {rs[0]['counts']}")
        log(f"tp ({'a' if tp == 2 else 'b'}) resume on {card}: the state "
            f"after the forced compress saved by every rank (gathered, rank 0 "
            f"writes; {rs[0]['save_s']:.3f} s with the fence), restored into "
            f"a fresh DeiT-S supernet sharded on the same mesh: the "
            f"post-prune step's metrics and watched leaves bit-equal to the "
            f"uninterrupted step's on every rank; restore s by rank "
            f"{[round(r['resumed']['restore_s'], 3) for r in rs]}; post-prune "
            f"step ms by rank uninterrupted "
            f"{[round(r['step_ms'][1], 1) for r in rs]}, resumed "
            f"{[round(r['resumed']['step_ms'], 1) for r in rs]}"
            + (f"; (a)'s checkpoint restored here: restore s by rank "
               f"{[round(r['cross']['restore_s'], 3) for r in rs]}, step ms "
               f"{[round(r['cross']['step_ms'], 1) for r in rs]}"
               if "cross" in resumes else ""))
        del saved
    log(f"tp resume across meshes on {card}: (a)'s checkpoint (mesh (1, 2)) "
        f"restored into one process (restore {one['cross']['restore_s']:.3f}"
        f" s, step {one['cross']['step_ms']:.1f} ms) and into (b)'s ranks; "
        f"each post-prune step against that mesh's own: " + "; ".join(
            crossed))
    log(f"tp (a), (b), (d) processes: {workers_s:.1f} s")
    for k, n in run_remat(A, card).items():
        totals[k] += n
    A.reset_launch_counts()
    return totals


# ---------------------------------------------------------------------------
# phase 14: the ladder (ofb_tpu_torch/scripts/), as a user runs it
# ---------------------------------------------------------------------------

LADDER_MODEL = "deit_small_patch16_224_mim"
LADDER_TARGETS = ("0.45", "0.70")
LADDER_EPOCHS = 3          # stage 1: epochs 0 and 1 (fuse point 1); stage 2: 2
LADDER_FUSE_POINT = 1
LADDER_FT_EPOCHS = 1
LADDER_BATCH = 64
# the ImageFolder: train and val JPEGs a class (10 classes: 5 train steps
# an epoch at LADDER_BATCH), the noise of make_imagefolder's ladder recipe
LADDER_DATA = dict(classes=10, per_class=32, val_per_class=8, noise=0.35)
LADDER_TIMEOUT = 600       # seconds one invocation of the ladder may take
# imported first in every process of the ladder: at exit, the attention
# launches of the process (a CLI's or a tool's) on its stdout, which the
# ladder script tees into the stage's log, and, after a stage-1 search
# (its fuse point before its last epoch), a copy of the running checkpoint
# it left
LADDER_HOOK = '''\
import atexit, json, os, shutil, sys, time

_T0 = time.time()


def _opt(name):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else None


def _at_exit():
    A = sys.modules.get("ofb_tpu_torch.ops.attention")
    if A is None:
        return
    counts = {}
    for (wrapper, body), n in A.launch_counts().items():
        counts.setdefault(wrapper, {})[body] = n
    out, fuse, epochs = (_opt("--output_dir"), _opt("--fuse_point"),
                         _opt("--epochs"))
    if sys.argv[0].endswith(os.path.join("cli", "search.py")) and out \\
            and fuse is not None and int(fuse) < int(epochs) - 1:
        shutil.copytree(os.path.join(out, "running_ckpt"),
                        os.path.join(out, "stage1_ckpt"), dirs_exist_ok=True)
    print("LADDER_LAUNCHES " + json.dumps(
        {"argv": sys.argv, "counts": counts,
         "seconds": round(time.time() - _T0, 1)}), flush=True)


atexit.register(_at_exit)
'''


def _ladder_runs(text):
    """[(argv, counts, seconds)] of the LADDER_LAUNCHES lines in `text`."""
    out = []
    for line in text.splitlines():
        if line.startswith("LADDER_LAUNCHES "):
            r = json.loads(line[len("LADDER_LAUNCHES "):])
            out.append((r["argv"], r["counts"], r["seconds"]))
    return out


def _read(path):
    with open(path) as f:
        return f.read()


def _ladder(env, root, what, **extra):
    """One invocation of ladder_imnet.sh on `root` in a process group of
    its own; returns its output and seconds (a failure or LADDER_TIMEOUT
    fails the phase)."""
    t0 = time.perf_counter()
    out, = _finish([_start(["bash", "ofb_tpu_torch/scripts/ladder_imnet.sh",
                            root], dict(env, **extra))], what,
                   timeout=LADDER_TIMEOUT)
    return out, time.perf_counter() - t0


def run_ladder(A, card, root):
    """Phase 14: `ofb_tpu_torch/scripts/ladder_imnet.sh` as a subprocess at
    DeiT-S full width and depth on a small JPEG ImageFolder (bf16, batch
    LADDER_BATCH, --cache-device --planned-epoch), its artifacts, skip on
    a second invocation, the hard eval, a prune timeline and a stage-2
    resume from the stage-1 checkpoint. Returns the attention launches of
    the first invocation's processes."""
    from ofb_tpu_torch.core.checkpoint import model_cfg_from_meta
    from ofb_tpu_torch.models.vit import ModelCfg
    from ofb_tpu_torch.scripts import make_imagefolder
    from ofb_tpu_torch.scripts.digits_story import dense_vit_gflops

    work = tempfile.mkdtemp(prefix="ofb_ladder_", dir=root)
    hook, bindir = os.path.join(work, "hook"), os.path.join(work, "bin")
    os.makedirs(hook)
    os.makedirs(bindir)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(LADDER_HOOK)
    # `python` in the ladder script is this interpreter (a wrapper, not a link:
    # a virtual environment is found from the path an interpreter runs as)
    with open(os.path.join(bindir, "python"), "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(bindir, "python"), 0o755)
    env = _dist_env(PYTHONPATH=os.pathsep.join(
        [hook] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        PATH=bindir + os.pathsep + os.environ.get("PATH", ""))
    # the train / val set and a harder val set, by make_imagefolder's main
    # in this process
    t0 = time.perf_counter()
    data, hard = os.path.join(work, "imfolder"), os.path.join(work, "hard")
    d = LADDER_DATA
    for args in (["--root", data, "--per-class", str(d["per_class"]),
                  "--noise", str(d["noise"]), "--seed", "0"],
                 ["--root", hard, "--per-class", "0", "--noise", "0.6",
                  "--seed", "7"]):
        make_imagefolder.main(["--classes", str(d["classes"]),
                               "--val-per-class", str(d["val_per_class"])]
                              + args)
    data_s = time.perf_counter() - t0
    env.update(DATA=data, DATA_SET="IMNET", DEVICE="cuda",
               MODEL=LADDER_MODEL, TARGETS=" ".join(LADDER_TARGETS),
               EPOCHS=str(LADDER_EPOCHS), FUSE_POINT=str(LADDER_FUSE_POINT),
               FT_EPOCHS=str(LADDER_FT_EPOCHS), BATCH=str(LADDER_BATCH))
    lroot = os.path.join(work, "ladder")
    rungs = {t: os.path.join(lroot, "t" + t) for t in LADDER_TARGETS}
    logs = {f"{t}/{stage}": os.path.join(r, stage + ".log")
            for t, r in rungs.items()
            for stage in ("search1", "search2", "finetune")}
    logs["dense"] = os.path.join(lroot, "dense_ft.log")

    # the first invocation: every stage of every rung, then the comparator
    out1, first_s = _ladder(env, lroot, "14 ladder")
    texts = {k: _read(p) for k, p in logs.items()}
    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)
    stages = {}
    for k, text in texts.items():
        runs = _ladder_runs(text)
        eps = _epochs(text)
        if len(runs) != 1:
            raise AssertionError(f"14 {k}: {len(runs)} processes logged")
        _, counts, sec = runs[0]
        if counts["attention_fwd"]["resident"] == 0 \
                or counts["attention_bwd"]["resident"] == 0 \
                or any(n for c in counts.values() for b, n in c.items()
                       if b != "resident"):
            raise AssertionError(f"14 {k}: attention launches {counts}")
        _add(totals, counts)
        stages[k] = {"seconds": sec, "epochs": [e[0] for e in eps],
                     "img_s": [e[1] for e in eps], "counts": counts}
    last = LADDER_EPOCHS - 1
    for t, r in rungs.items():
        s1, s2 = texts[f"{t}/search1"], texts[f"{t}/search2"]
        if stages[f"{t}/search1"]["epochs"] != list(range(
                LADDER_FUSE_POINT + 1)) or f"breaking at fuse_point " \
                f"{LADDER_FUSE_POINT}" not in s1 or "resumed from" in s1:
            raise AssertionError(f"14 t{t}: stage 1 did not stop at the "
                                 f"fuse point:\n{s1[-2000:]}")
        if stages[f"{t}/search2"]["epochs"] != [last] or \
                f"resumed from {r}/running_ckpt at epoch {last}" not in s2:
            raise AssertionError(f"14 t{t}: stage 2 did not resume at "
                                 f"epoch {last}:\n{s2[-2000:]}")
        for part in ("ft/best", "ft/running_ckpt", "stage1_ckpt"):
            if not os.path.exists(os.path.join(r, part, "meta.json")):
                raise AssertionError(f"14 t{t}: no {part}")
        st = json.loads(_read(os.path.join(r, "STATUS.json")))
        if st["stage"] != "finetune" or not st["search_done"] \
                or st["ft_epoch"] != LADDER_FT_EPOCHS - 1:
            raise AssertionError(f"14 t{t}: STATUS.json {st}")
    if not os.path.exists(os.path.join(lroot, "dense_ft", "best",
                                       "meta.json")):
        raise AssertionError("14: no dense_ft/best")
    ladder_json = _read(os.path.join(lroot, "ladder.json"))
    rows = {r["name"]: r for r in json.loads(ladder_json)}
    if sorted(rows) != sorted(["dense"] + ["t" + t for t in LADDER_TARGETS]):
        raise AssertionError(f"14: ladder.json rows {sorted(rows)}")
    for name, row in rows.items():
        src = os.path.join(lroot, "dense_ft", "best") if name == "dense" \
            else os.path.join(lroot, name, "ft", "running_ckpt")
        cfg = model_cfg_from_meta(json.loads(_read(os.path.join(
            src, "meta.json")))["model_cfg"], ModelCfg)
        if row["gflops"] != dense_vit_gflops(cfg) or not row.get("params"):
            raise AssertionError(f"14 {name}: ladder.json row {row}, "
                                 f"dense_vit_gflops {dense_vit_gflops(cfg)}")
    top = json.loads(_read(os.path.join(lroot, "STATUS.json")))
    if not top["summary"] or len(top["rungs"]) != len(LADDER_TARGETS) + 1:
        raise AssertionError(f"14: root STATUS.json {top}")

    # the same command again: every stage skipped, the table unchanged
    sizes = {k: os.path.getsize(p) for k, p in logs.items()}
    out2, again_s = _ladder(env, lroot, "14 ladder again")
    for what in ("stage 1 complete", "stage 2 complete",
                 "finetune complete"):
        if out2.count(what) != len(LADDER_TARGETS):
            raise AssertionError(f"14 again: '{what}' not printed for "
                                 f"every rung:\n{out2[-3000:]}")
    grew = [k for k, p in logs.items() if os.path.getsize(p) != sizes[k]]
    clis = [r for r in _ladder_runs(out2)
            if os.sep + "cli" + os.sep in r[0][0]]
    if grew or _epochs(out2) or clis:
        raise AssertionError(f"14 again: a stage ran (logs grown: {grew})")
    if _read(os.path.join(lroot, "ladder.json")) != ladder_json:
        raise AssertionError("14 again: ladder.json changed")

    # meanwhile (other directories of the root, the table left alone): the
    # hard eval of every target on the val split and a harder one, into a
    # file of its own, and a rung's prune timeline; then a rung put back to
    # its stage-1 checkpoint resumes stage 2
    t1 = time.perf_counter()
    he_path = os.path.join(work, "hard_eval.json")
    t045 = rungs[LADDER_TARGETS[0]]
    tools = [_start([sys.executable, "-m",
                     "ofb_tpu_torch.scripts.ladder_hard_eval", "--root", lroot,
                     "--val-roots", data, hard, "--device", "cuda", "--out",
                     he_path], env),
             _start([sys.executable, "-m",
                     "ofb_tpu_torch.scripts.prune_timeline",
                     os.path.join(t045, "search1.log"), "--log-txt",
                     os.path.join(t045, "log.txt")], env)]
    shutil.rmtree(os.path.join(t045, "running_ckpt"))
    shutil.copytree(os.path.join(t045, "stage1_ckpt"),
                    os.path.join(t045, "running_ckpt"))
    before = _read(logs[f"{LADDER_TARGETS[0]}/search2"])
    out3, resume_s = _ladder(env, lroot, "14 ladder resume",
                             TARGETS=LADDER_TARGETS[0])
    he_out, pt = _finish(tools, "14 ladder_hard_eval, prune_timeline")
    tools_s = time.perf_counter() - t1
    new = _read(logs[f"{LADDER_TARGETS[0]}/search2"])[len(before):]
    if "stage 1 complete (epoch 1)" not in out3 \
            or [e[0] for e in _epochs(new)] != [last] \
            or f"resumed from {t045}/running_ckpt at epoch {last}" \
            not in new:
        raise AssertionError(f"14 resume: stage 2 did not resume at epoch "
                             f"{last}:\n{out3[-3000:]}")
    he = json.loads(_read(he_path))
    names = sorted(r["name"] for r in he["rows"])
    want = sorted(f"{n}/{k}" for n in ["dense"] + ["t" + t for t in
                                                   LADDER_TARGETS]
                  for k in ("best", "final"))
    if names != want or not all(
            0.0 <= a <= 100.0 for r in he["rows"] for a in r["acc1"].values()):
        raise AssertionError(f"14 hard eval: {he['rows']}")
    (_, he_counts, _), = _ladder_runs(he_out)
    log(f"ladder (14) on {card}: ladder_imnet.sh, {LADDER_MODEL} bf16, "
        f"batch {LADDER_BATCH}, targets {LADDER_TARGETS}, EPOCHS "
        f"{LADDER_EPOCHS}, FUSE_POINT {LADDER_FUSE_POINT}, FT_EPOCHS "
        f"{LADDER_FT_EPOCHS}, IMNET ImageFolder of "
        f"{d['classes'] * d['per_class']} + "
        f"{d['classes'] * d['val_per_class']} JPEGs ({data_s:.1f} s to "
        f"write); first invocation {first_s:.1f} s, again (all skipped) "
        f"{again_s:.1f} s, resume of stage 2 {resume_s:.1f} s beside the "
        f"hard eval and the prune timeline ({tools_s:.1f} s in all); prune "
        f"timeline: {pt.strip().splitlines()[-1]}")
    for k, v in stages.items():
        log(f"  ladder {k}: {v['seconds']} s (process), epochs {v['epochs']} "
            f"at {v['img_s']} img/s sustained, launches {v['counts']}")
    log("  ladder.json: " + json.dumps(
        [{k: r.get(k) for k in ("name", "gflops", "params", "embed_dim",
                                "acc1", "searched_gflops")}
         for r in rows.values()]))
    log("  hard eval acc1 by val root: " + json.dumps(
        {r["name"]: {os.path.basename(v): a for v, a in r["acc1"].items()}
         for r in he["rows"]}) + f"; launches {he_counts}")
    return totals


TOOLS_IMAGES = dict(classes=8, per_class=32)   # data_bench's ImageFolder
TOOLS_STEPS = 20           # perf_breakdown's and swin_breakdown's steps
TOOLS_ITERS = 20           # augment_breakdown's iterations
STORY_STEPS = (1500, 600)  # compression_story's search and finetune steps
ONE_UINT8_STEP = 0.017     # (1 / 255) / std in normalised units


def _tool(A, what, fn, *args):
    """fn(*args) with the attention counts from 0: (its result, the
    launches by wrapper and body, seconds)."""
    A.reset_launch_counts()
    t = time.perf_counter()
    out = fn(*args)
    sec = time.perf_counter() - t
    counts = by_body(A)
    log(f"  {what}: {sec:.1f} s, attention launches {counts}")
    return out, counts, sec


def _positive(what, values):
    bad = {k: v for k, v in values.items()
           if not (isinstance(v, float) and math.isfinite(v) and v > 0)}
    if bad:
        raise AssertionError(f"15 {what}: not finite and positive: {bad}")


def run_tools(A, card, root):
    """Phase 15: the performance tools, the examples and `dryrun.entry`,
    each through its `main(argv)` in this process (kpad_probe also once as
    `python -m`), at full width: perf_breakdown (DeiT-S, batch 256),
    augment_breakdown (256, 256 -> 224), swin_breakdown (Swin-T, 128),
    kpad_probe (its shapes), data_bench (an ImageFolder of 256 JPEGs),
    minimal_search, compression_story (its default lengths) and entry().
    Each one's attention launches are counted from 0. Returns (the
    launches of the phase, the unaligned body's rows at the story's
    shapes, where the story launched it)."""
    import torch
    from ofb_tpu_torch import dryrun
    from ofb_tpu_torch.examples import compression_story, minimal_search
    from ofb_tpu_torch.models import swin as swin_mod
    from ofb_tpu_torch.scripts import (augment_breakdown, data_bench,
                                       kpad_probe, make_imagefolder,
                                       perf_breakdown, swin_breakdown)

    totals = dict.fromkeys(kernel_counts(only("resident", 0, 0)), 0)
    log(f"tools (15) on {card}:")
    work = tempfile.mkdtemp(prefix="ofb_tools_", dir=root)
    # the module entry of one tool, beside the ImageFolder's writing
    kp = _start([sys.executable, "-m", "ofb_tpu_torch.scripts.kpad_probe"],
                _dist_env())
    data = os.path.join(work, "imf")
    t = time.perf_counter()
    make_imagefolder.main(["--root", data, "--classes",
                           str(TOOLS_IMAGES["classes"]), "--per-class",
                           str(TOOLS_IMAGES["per_class"]), "--val-per-class",
                           "0"])
    write_s = time.perf_counter() - t
    (kp_out,) = _finish([kp], "15 python -m kpad_probe")
    if len([ln for ln in kp_out.splitlines() if '"tf_s"' in ln]) != 5:
        raise AssertionError(f"15 python -m kpad_probe:\n{kp_out}")
    log(f"  python -m ofb_tpu_torch.scripts.kpad_probe: exit 0, 5 lines; "
        f"the ImageFolder {write_s:.1f} s")

    # perf_breakdown: 5 rows of (warm-up 2 + steps) calls through the
    # DeiT-S blocks, 4 of them with a backward, all resident
    pb, c, _ = _tool(A, "perf_breakdown", perf_breakdown.main, [
        "--model", "deit_small", "--batch", "256", "--steps",
        str(TOOLS_STEPS)])
    calls = (TOOLS_STEPS + 2) * 12
    _expect_counts(c, 5 * calls, 4 * calls, "15 perf_breakdown")
    _add(totals, c)
    _positive("perf_breakdown img/s", {k: float(r["img_s"])
                                       for k, r in pb["rows"].items()})
    _positive("perf_breakdown mfu", {k: float(r["mfu"]) for k, r in
                                     pb["rows"].items()
                                     if k != "augment_only"})
    if pb["rows"]["eval_fwd"]["img_s"] <= pb["rows"]["search_step"]["img_s"]:
        raise AssertionError(f"15 perf_breakdown: eval_fwd not faster than "
                             f"search_step: {pb['rows']}")

    ab, c, _ = _tool(A, "augment_breakdown", augment_breakdown.main, [
        "--batch", "256", "--stage", "256", "--out-size", "224", "--iters",
        str(TOOLS_ITERS)])
    _expect_counts(c, 0, 0, "15 augment_breakdown")
    _positive("augment_breakdown ms", ab["ms"])
    if not ab["delta"]["mean"] <= ONE_UINT8_STEP:
        raise AssertionError(f"15 augment_breakdown: bf16 geometry delta "
                             f"{ab['delta']}")
    log("  augment_breakdown: " + json.dumps(ab))

    real = (swin_mod._window_attention, swin_mod.shifted_windows)
    sb, c, _ = _tool(A, "swin_breakdown", swin_breakdown.main, [
        "--model", "swin_tiny", "--batch", "128", "--steps",
        str(TOOLS_STEPS)])
    _expect_counts(c, 0, 0, "15 swin_breakdown")
    _positive("swin_breakdown img/s", sb)
    if (swin_mod._window_attention, swin_mod.shifted_windows) != real:
        raise AssertionError("15 swin_breakdown left a stub in place")

    kl, c, _ = _tool(A, "kpad_probe", kpad_probe.main, [])
    _expect_counts(c, 0, 0, "15 kpad_probe")
    _positive("kpad_probe TF/s", {f"{ln['shape']} {k}": float(ln[k])
                                  for ln in kl for k in (
                                      "tf_s", "tf_s_padded_effective")})

    db, c, _ = _tool(A, "data_bench", data_bench.main, [
        "--root", os.path.join(data, "train"), "--n", "256"])
    _expect_counts(c, 0, 0, "15 data_bench")
    _positive("data_bench img/s", db)

    ms, c, _ = _tool(A, "minimal_search", minimal_search.main, [])
    # fp32: 5 search steps and one finetune step through 2 blocks, general
    _expect_counts(c, 12, 12, "15 minimal_search", body="general")
    _add(totals, c)
    if not math.isfinite(ms):
        raise AssertionError(f"15 minimal_search: loss {ms}")

    story, c, story_s = _tool(A, "compression_story", compression_story.main,
                              ["--steps", str(STORY_STEPS[0]),
                               "--finetune-steps", str(STORY_STEPS[1])])
    _add(totals, c)
    if not story["flops_pct"] < 100.0:
        raise AssertionError(f"15 compression_story: {story}")
    # the supernet's 3 blocks resident in every search step and supernet
    # eval (every 300 steps and once after); the subnet's blocks, (heads,
    # head dim, MLP) each, by their bodies in every finetune step and in
    # its two evals
    scfg = story["cfg"]
    N = scfg.num_patches + scfg.num_tokens
    bodies = [A.attention_body(N, d, torch.bfloat16).name
              for _, d, _ in story["blocks"]]
    shapes = sorted({(128, N, h, d) for h, d, _ in story["blocks"]
                     if A.attention_body(N, d, torch.bfloat16).name
                     == "unaligned"})
    steps, ft = STORY_STEPS
    depth = compression_story.CFG["depth"]
    n_una, n_res = bodies.count("unaligned"), bodies.count("resident")
    want = {"attention_fwd": {"resident": steps * depth + (
        steps // 300 + 1) * depth + (ft + 2) * n_res, "streaming": 0,
        "unaligned": (ft + 2) * n_una, "general": 0},
        "attention_bwd": {"resident": steps * depth + ft * n_res,
                          "streaming": 0, "unaligned": ft * n_una,
                          "general": 0}}
    if c != want or n_una + n_res != depth:
        raise AssertionError(f"15 compression_story: launches {c}, expected "
                             f"{want} (subnet bodies {bodies})")
    log(f"  compression_story: {story_s:.1f} s; " + json.dumps(
        {k: v for k, v in story.items() if k != "cfg"}))

    (fn, args), _, _ = _tool(A, "entry() built", dryrun.entry, "cuda")
    with torch.no_grad():
        logits, c, _ = _tool(A, "entry() forward", fn, *args)
    if logits.shape != (8, 1000) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"15 entry(): logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    _expect_counts(c, 12, 0, "15 entry()")
    _add(totals, c)
    log(f"  entry(): logits (8, 1000) finite, |max| "
        f"{logits.abs().max().item():.4f}")
    log("  tools launches by kernel: " + json.dumps(totals))
    del fn, args, logits
    shutil.rmtree(work, ignore_errors=True)
    if not shapes:
        return totals, []
    errs = check_kernels(A, [(s, torch.bfloat16, "unaligned") for s in shapes])
    return totals, time_unaligned(A, [(s, 0) for s in shapes], errs,
                                  "the story's")


# phase 16: the layer-norm kernel pair (ops/layer_norm.py, csrc/layer_norm.cu)
LN_EPS = 1e-6
# (leading dims, D, kind) held against the plain versions in bf16 and fp32:
# kind None is the plain norm, 'zero' / 'identity' the passthrough of a mask
# with dead channels, 'dead' a mask with no live channel ('zero'). The main
# path's shapes (the search's block and final norms, the finetune's), then
# ragged ones: Swin-T's first stage (96), an exported subnet's width (276),
# ViT-H's (1280: the looped kernels), odd row counts, widths whose rows
# take the looped kernels for their alignment (262 in bf16, 7 in fp32)
LN_CHECKS = (((256, 197), 384, "identity"), ((256, 197), 384, "zero"),
             ((256, 197), 192, None), ((3, 17), 96, "identity"),
             ((5, 33), 276, "zero"), ((7, 13), 276, None),
             ((2, 257), 1280, None), ((3, 257), 1280, "identity"),
             ((33,), 384, "dead"), ((1,), 8, None), ((5, 7), 262, "zero"),
             ((3, 5), 7, None))
# ... timed in bf16, the main path's type: (leading dims, D, kind, calls a
# search call makes of it, a finetune call's)
LN_TIMING = (((256, 197), 384, "identity", 4 * 24, 0),
             ((256, 197), 384, "zero", 4, 0),
             ((256, 197), 192, None, 0, 25))
# launches a call of the planned main path, (forward, backward) by kind:
# the search (4 microbatches of 25 norms), one data-parallel rank's search
# (1 microbatch), the finetune's dense DeiT-Ti (1)
LN_LAUNCHES = (("search", 4, "masked", 100), ("search rank", 1, "masked", 25),
               ("finetune", 1, "plain", 25))
# least share of its bytes bound each kernel reaches at the main path's shapes
LN_MIN_BOUND = 0.6
# max |kernel - plain| per element. bf16 (y, dx): the same fp32 arithmetic
# summed in another order can round to the neighbouring bf16 value, one step
# of at most 2^-7 of the value. fp32: summation order, as a share of the
# largest |plain| of the tensor (rows of up to 1280, columns of 50432 rows)
TOL_LN = {"bfloat16": 2.0 ** -7, "float32": 1e-5}


def _ln_inputs(lead, D, kind, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(lead + (D,), generator=g, device="cuda") * 2 + 0.5
         ).to(dtype)
    dy = torch.randn(lead + (D,), generator=g, device="cuda").to(dtype)
    scale = 1 + 0.3 * torch.randn(D, generator=g, device="cuda")
    bias = 0.2 * torch.randn(D, generator=g, device="cuda")
    mask = None
    if kind == "dead":
        mask = torch.zeros(D, device="cuda")
    elif kind is not None:
        mask = (torch.rand(D, generator=g, device="cuda") > 0.3).float()
    return x.reshape(-1, D), dy.reshape(-1, D), mask, scale, bias


def _ln_close(what, got, want, dtype, per_element):
    import torch
    got, want = got.float(), want.float()
    tol = TOL_LN[str(dtype).split(".")[-1]]
    if per_element:
        bound = tol * want.abs() + 1e-6
    else:
        bound = tol * want.abs().max() + 1e-6
    err = (got - want).abs()
    if not torch.isfinite(got).all() or (err > bound).any():
        raise AssertionError(f"16 {what}: kernel against the plain version "
                             f"off by {err.max().item():.3e}")
    return err.max().item()


def check_layer_norm(L):
    """Phase 16 (a): each kernel against its plain version (run on the card)
    at LN_CHECKS in bf16 and fp32; dropped channels exactly 0 or x (dy); a
    second backward, and a CUDA graph of forward + backward replayed, equal
    the first eager call bit for bit. Returns the largest errors."""
    import torch
    worst = {}
    for lead, D, kind in LN_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            x, dy, mask, scale, bias = _ln_inputs(lead, D, kind, dtype, D)
            pt = "zero" if kind == "dead" else kind
            want_f = L.layer_norm_fwd_reference(x, mask, scale, bias, LN_EPS,
                                                pt)
            want_b = L.layer_norm_bwd_reference(x, dy, mask, scale,
                                                want_f[1], want_f[2], pt)
            got_f = L.layer_norm_fwd(x, mask, scale, bias, LN_EPS, pt)
            got_b = L.layer_norm_bwd(x, dy, mask, scale, got_f[1], got_f[2],
                                     pt)
            again = L.layer_norm_bwd(x, dy, mask, scale, got_f[1], got_f[2],
                                     pt)
            torch.cuda.synchronize()
            what = f"{lead + (D,)} {kind} {str(dtype)[6:]}"
            for name, g, w in zip(("y", "mean", "rstd", "dx", "dgamma",
                                   "dbeta"), got_f + got_b, want_f + want_b):
                elem = name in ("y", "dx") and dtype == torch.bfloat16
                key = (name, str(dtype)[6:])
                worst[key] = max(worst.get(key, 0.0), _ln_close(
                    f"{what} {name}", g, w, dtype, elem))
            if mask is not None:
                dead = mask == 0
                keep = pt == "identity"
                for name, g, src in (("y", got_f[0], x), ("dx", got_b[0], dy)):
                    want = src[:, dead] if keep else torch.zeros_like(
                        src[:, dead])
                    if not torch.equal(g[:, dead], want):
                        raise AssertionError(f"16 {what}: {name} on dropped "
                                             "channels")
                for g in got_b[1:]:
                    if g[dead].any():
                        raise AssertionError(f"16 {what}: dgamma / dbeta on "
                                             "dropped channels")
            if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
                raise AssertionError(f"16 {what}: a second backward differs")
    # a CUDA graph of forward + backward at the search's block norm
    x, dy, mask, scale, bias = _ln_inputs((256, 197), 384, "identity",
                                          torch.bfloat16, 7)

    def pair():
        y, mean, rstd = L.layer_norm_fwd(x, mask, scale, bias, LN_EPS,
                                         "identity")
        return (y,) + L.layer_norm_bwd(x, dy, mask, scale, mean, rstd,
                                       "identity")
    eager = pair()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        pair()                                   # warm the side stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = pair()
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(eager, outs)):
        raise AssertionError("16: a graph replay of forward + backward "
                             "differs from the eager call")
    log(f"16 layer norm: kernels against the plain versions at "
        f"{len(LN_CHECKS)} shapes x (bf16, fp32), largest errors "
        f"{ {'/'.join(k): f'{v:.2e}' for k, v in worst.items()} } (tol "
        f"{TOL_LN}); dropped channels exact; a second backward and a graph "
        "replay bit-equal")
    return {"/".join(k): v for k, v in worst.items()}


def time_layer_norm(L):
    """Phase 16 (b): at LN_TIMING, bf16, device time (torch.profiler) of
    the forward kernel and the backward kernels, beside their bytes bound
    (read x (and dy), write y (dx), the row moments), the eager chain they
    replace (`masked_layer_norm_reference` / `layer_norm_reference`, the
    forward with autograd recording, the backward as autograd runs it) and
    torch's layer_norm (`library_ms`, the yardstick only: the port never
    calls it). Returns a row a shape, with the chain's and the kernels' ms a
    search call and a finetune call."""
    import torch
    import torch.nn.functional as F
    rows = []
    for lead, D, kind, n_search, n_ft in LN_TIMING:
        x, dy, mask, scale, bias = _ln_inputs(lead, D, kind, torch.bfloat16,
                                              11)
        R, isz = x.shape[0], x.element_size()
        y, mean, rstd = L.layer_norm_fwd(x, mask, scale, bias, LN_EPS, kind)
        ms = {"fwd": device_time_ms(lambda: L.layer_norm_fwd(
                  x, mask, scale, bias, LN_EPS, kind)),
              "bwd": device_time_ms(lambda: L.layer_norm_bwd(
                  x, dy, mask, scale, mean, rstd, kind))}
        xr = x.detach().requires_grad_()
        sr, br = scale.detach().requires_grad_(), bias.detach().requires_grad_()

        def chain():
            if kind is None:
                return L.layer_norm_reference(xr, sr, br, eps=LN_EPS)
            return L.masked_layer_norm_reference(xr, mask, sr, br, eps=LN_EPS,
                                                 passthrough=kind)
        yc = chain()
        ms["plain_fwd"] = device_time_ms(chain)
        ms["plain_bwd"] = device_time_ms(lambda: torch.autograd.grad(
            yc, (xr, sr, br), dy, retain_graph=True))
        sl, bl = (t.to(torch.bfloat16).requires_grad_() for t in (scale, bias))
        yl = F.layer_norm(xr, (D,), sl, bl, LN_EPS)
        ms["library_fwd"] = device_time_ms(
            lambda: F.layer_norm(xr, (D,), sl, bl, LN_EPS))
        ms["library_bwd"] = device_time_ms(lambda: torch.autograd.grad(
            yl, (xr, sl, bl), dy, retain_graph=True))
        bound = {"fwd": (2 * R * D * isz + 2 * R * 4) / HBM_BYTES_PER_S * 1e3,
                 "bwd": (3 * R * D * isz + 2 * R * 4) / HBM_BYTES_PER_S * 1e3}
        row = dict(shape=list(lead) + [D], kind=kind or "plain",
                   bound_ms=bound, ms=ms,
                   bound_share={k: bound[k] / ms[k] for k in bound},
                   calls_search=n_search, calls_finetune=n_ft)
        rows.append(row)
        log(f"16 layer norm {tuple(lead) + (D,)} {kind or 'plain'} bf16: "
            f"kernel fwd {ms['fwd']:.4f} / bwd {ms['bwd']:.4f} ms (bytes "
            f"bound {bound['fwd']:.4f} / {bound['bwd']:.4f}: "
            f"{100 * bound['fwd'] / ms['fwd']:.1f}% / "
            f"{100 * bound['bwd'] / ms['bwd']:.1f}%), eager chain "
            f"{ms['plain_fwd']:.4f} / {ms['plain_bwd']:.4f}, torch layer_norm "
            f"{ms['library_fwd']:.4f} / {ms['library_bwd']:.4f}")
    for cell in ("search", "finetune"):
        per = {k: sum(r[f"calls_{cell}"] * r["ms"][k] for r in rows)
               for k in ("fwd", "bwd", "plain_fwd", "plain_bwd")}
        log(f"16 layer norm a {cell} call: eager chain {per['plain_fwd']:.2f} "
            f"ms forward + {per['plain_bwd']:.2f} backward, the kernels "
            f"{per['fwd']:.2f} + {per['bwd']:.2f}")
    return rows


def count_layer_norm_launches(L):
    """Phase 16 (c): the layer-norm launches a replay of the planned main
    path's steps runs (`PlannedStep.launches_per_replay`): LN_LAUNCHES."""
    import dataclasses
    import torch
    from ofb_tpu_torch import bench as B
    from ofb_tpu_torch.bench import PlannedCalls
    from ofb_tpu_torch.core.steps import make_planned_search_step
    from ofb_tpu_torch.models.registry import create_model

    mb, got = 16, {}
    for what, A_, kind, n in LN_LAUNCHES:
        L.reset_launch_counts()
        if what.startswith("search"):
            bundle, state, _, _, _ = B.build_step("deit_small", mb, seed=8)
            scfg, tx = B.search_config(mb)
            scfg = dataclasses.replace(scfg, accum_iter=A_)
            pstep, _ = make_planned_search_step(
                bundle.space, bundle.cfg, scfg, tx, phase="search",
                steps_per_epoch=9, device="cuda")
            calls = PlannedCalls(pstep, {"state": state}, mb * A_, 9,
                                 search=True, images=64, seed=9)
        else:
            bundle = create_model("deit_tiny_patch16_224", device="cuda")
            dense = bundle.init(5)
            _, _, _, fstate, pstep, _ = B.build_subnet_steps(
                None, None, mb, subnet=(dense, bundle.cfg), planned=True)
            calls = PlannedCalls(pstep, {"state": fstate}, mb, 9,
                                 search=False, images=64, seed=9)
        for _ in range(pstep.WARMUP + 2):         # eager, capture, replay
            calls.graph()
        torch.cuda.synchronize()
        per = {k: n_ for k, n_ in pstep.launches_per_replay.items()
               if k[0].startswith("layer_norm")}
        want = {(w, k): (n if k == kind else 0)
                for w in ("layer_norm_fwd", "layer_norm_bwd")
                for k in ("masked", "plain")}
        if pstep.captures != 1 or per != want:
            raise AssertionError(f"16 {what}: layer-norm launches a replay "
                                 f"{per}, wanted {want}")
        got[what] = per
        del calls, pstep
        torch.cuda.empty_cache()
    log(f"16 layer norm launches a replay: "
        f"{ {w: [n for n in c.values() if n] for w, c in got.items()} }")
    return got


def run_layer_norm(A):
    """Phase 16: the layer-norm kernel pair: (a) against the plain
    versions, (b) timed at the main path's shapes, each kernel at
    LN_MIN_BOUND of its bytes bound or more, (c) the launches a call of the
    planned main path."""
    from ofb_tpu_torch.ops import layer_norm as L
    errs = check_layer_norm(L)
    rows = time_layer_norm(L)
    slow = [(r["shape"], r["kind"], k, round(s, 3)) for r in rows
            for k, s in r["bound_share"].items() if s < LN_MIN_BOUND]
    if slow:
        raise AssertionError(f"16 layer-norm kernels under {LN_MIN_BOUND} of "
                             f"their bytes bound: {slow}")
    launches = count_layer_norm_launches(L)
    return dict(max_abs_err=errs, timing=rows, launches_per_replay={
        w: {f"{a}/{b}": n for (a, b), n in c.items() if n}
        for w, c in launches.items()})


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
    unaligned_times = timed("3 unaligned", time_unaligned, A,
                            UNALIGNED_TIMING, errs)
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
        swin, window = timed("11", run_swin, A, smi, root)
        dist = timed("12", run_dist, A, smi, root)
        tp = timed("13", run_tp, A, smi, root)
        ladder = timed("14", run_ladder, A, smi, root)
        tools, story_unaligned = timed("15", run_tools, A, smi, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    layer_norm = timed("16", run_layer_norm, A)
    log(f"seconds by phase: {json.dumps(seconds)}")

    kernels = []
    for name, src, line in (
            ("attention_fwd", "attention_fwd_resident.cu", 68),
            ("attention_bwd", "attention_bwd_resident.cu", 81),
            ("attention_fwd_general", "attention_fwd.cu", 68),
            ("attention_bwd_general", "attention_bwd.cu", 81),
            ("attention_fwd_unaligned", "attention_fwd_unaligned.cu", 68),
            ("attention_bwd_unaligned", "attention_bwd_unaligned.cu", 81),
            ("attention_fwd_streaming", "attention_fwd_streaming.cu", 115),
            ("attention_bwd_streaming", "attention_bwd_streaming.cu", 127)):
        phases = dict(launches_fp32=fp32[name] + small[name]
                      + vit_fp32.get(name, 0),
                      launches_search=launches[name],
                      launches_lifecycle=lifecycle[name],
                      launches_cli=cli[name], launches_384=at384[name],
                      launches_planned=planned[name],
                      launches_vit=vit[name], launches_swin=swin[name],
                      launches_dist=dist[name], launches_tp=tp[name],
                      launches_ladder=ladder[name],
                      launches_tools=tools[name])
        # the streaming body's times are at 577 tokens; the general body's
        # in fp32 at 197 tokens (its 577-token times stand beside them); the
        # unaligned body's at the first shape of UNALIGNED_TIMING, with every
        # timed shape and the story's beside them
        if name.endswith("_unaligned"):
            n = name.split("_")[1]
            timed = _kernel_fields(unaligned_times[0], n)
            del timed["max_abs_err"]             # errs[name], the same
            timed["shapes"] = [_kernel_fields(r, n) for r in unaligned_times]
            timed["story"] = [_kernel_fields(r, n) for r in story_unaligned]
        else:
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
    log(json.dumps({"attention_unaligned": unaligned_times}))
    log(json.dumps({"attention_unaligned_story": story_unaligned}))
    log("device time: profiler sessions taken as whole {whole}, taken as "
        "agreeing {agreed}, dropped {dropped}; times from queued_time_ms "
        "{queued}".format(**SESSIONS))
    log(smi)
    log(json.dumps({"window_attention": window}))
    log(json.dumps({"layer_norm": layer_norm}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    # the processes of phases 12 and 13 run this file with a role; so does
    # a timing of one attention body (`time_body_worker`)
    if sys.argv[1:2] == ["--dist-step"]:
        dist_step_worker()
    elif sys.argv[1:2] == ["--dist-clis"]:
        dist_clis_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--dist-pair"]:
        dist_pair_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif sys.argv[1:2] == ["--time-body"]:
        time_body_worker(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--tp-step"]:
        tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5], *sys.argv[6:7])
    else:
        sys.exit(main())
