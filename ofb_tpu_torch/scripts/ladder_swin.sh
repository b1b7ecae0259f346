#!/usr/bin/env bash
# OFB-Swin accuracy-vs-FLOPs ladder at registry geometry on the file-based
# ImageFolder (the OFB-Swin-A/B/C analog — reference README.md:27-31),
# through the all-in-one Swin search CLI (search -> force-finish export ->
# sliced-subnet finetune in one invocation). Port of scripts/ladder_swin.sh
# through the port's CLIs and tools.
#
# Targets straddle the ~2.54 GFLOPs uniform-alpha expectation of the
# swin_tiny supernet (dense = 4.52 GFLOPs) so each rung pulls a distinct
# direction, mirroring ladder_imnet.sh.
#
# BLR_ARCH defaults to the measured organic-kill recipe: alpha drift is
# linear in arch lr and the 20k-image cache gives 64x fewer arch steps per
# epoch than the reference's ImageNet runs; 8x restores per-epoch search
# dynamics (alpha_dynamics projection; BENCH.md round 4).
#
# Beside the JAX script's knobs: DEVICE (passed as --device to the search
# CLI and the hard eval; cuda raises without a card), DATA_SET (the CLI's
# --data-set) and one variable of extra flags for each process the rungs
# start: SEARCH_EXTRA (cli.search_swin) and HARD_EVAL_EXTRA
# (ladder_hard_eval, e.g. "--val-roots DIR").
#
# Usage: DATA=/tmp/imfolder bash ofb_tpu_torch/scripts/ladder_swin.sh \
#            runs/ladder_swin
set -euo pipefail

EXP_ROOT=${1:-runs/ladder_swin}
DATA=${DATA:-/tmp/imfolder}
DATA_SET=${DATA_SET:-IMNET}
DEVICE=${DEVICE:-cuda}
MODEL=${MODEL:-swin_tiny_patch4_window7_224_mim}
EPOCHS=${EPOCHS:-60}
# batch 128 is the benched Swin search config and the memory-safe one with
# the --cache-device staging set resident on a 16 GiB accelerator (batch
# 256 + cache needed 17.09G there). Arch drift/epoch is batch-invariant
# (lr_arch scales by eff_batch/256, steps/epoch by its inverse), so the
# organic recipe transfers unchanged.
BATCH=${BATCH:-128}
FT_EPOCHS=${FT_EPOCHS:-40}
DENSE_GFLOPS=4.519   # swin_model_flops() dense term of the swin_tiny supernet
# 0.95 is the near-dense capacity reference (force-finish at the top of
# the ratio grid keeps ~everything) — the ladder's "dense row" without a
# separate dense-Swin trainer; 0.45/0.70 straddle the ~0.56x uniform-
# alpha expectation.
TARGETS=${TARGETS:-"0.45 0.70 0.95"}
W_FLOPS=${W_FLOPS:-2000}
BLR_ARCH=${BLR_ARCH:-2e-3}
SEARCH_EXTRA=${SEARCH_EXTRA:-}
HARD_EVAL_EXTRA=${HARD_EVAL_EXTRA:-}
cd "$(dirname "$0")/../.."
mkdir -p "$EXP_ROOT"

for FRAC in $TARGETS; do
  TGT=$(python -c "print(f'{$DENSE_GFLOPS * $FRAC:.3f}')")
  EXP="$EXP_ROOT/t$FRAC"
  mkdir -p "$EXP"
  if [ -f "$EXP/model_finetuned/meta.json" ]; then
    echo "=== swin target $FRAC already complete (model_finetuned present); skipping ==="
    continue
  fi
  echo "=== swin target $FRAC x dense = $TGT GFLOPs -> $EXP ==="
  # outer retry: --auto-resume covers transient in-process errors, but a
  # killed PROCESS (a lost shell, the OOM-killer) needs this loop; a
  # running_ckpt left by the previous attempt turns the retry into a
  # resume instead of a from-scratch repeat (search epochs only — the
  # ft stage re-runs from model_exported, which is saved atomically)
  for attempt in 1 2 3; do
    RESUME=""
    [ -f "$EXP/running_ckpt/meta.json" ] && RESUME="--resume"
    if python -m ofb_tpu_torch.cli.search_swin --data-path "$DATA" \
        --data-set "$DATA_SET" --device "$DEVICE" \
        --model "$MODEL" --target_flops "$TGT" --w_flops "$W_FLOPS" \
        --blr_arch "$BLR_ARCH" \
        --epochs "$EPOCHS" --batch-size "$BATCH" --embed_search \
        --cache-device --planned-epoch --force-finish \
        --export-finetune-epochs "$FT_EPOCHS" \
        --output_dir "$EXP" $RESUME $SEARCH_EXTRA \
        2>&1 | tee -a "$EXP/search.log"; then
      break
    fi
    echo "!!! rung $FRAC attempt $attempt failed at $(date); retrying"
    sleep 30
  done
  [ -f "$EXP/model_finetuned/meta.json" ] \
      || echo "!!! rung $FRAC FAILED after 3 attempts (continuing)"
done

# hard-val generalization rows for every exported+finetuned rung
python -m ofb_tpu_torch.scripts.ladder_hard_eval --root "$EXP_ROOT" \
    --family swin --device "$DEVICE" $HARD_EVAL_EXTRA \
    2>&1 | tee "$EXP_ROOT/hard_eval.log" || true

# organic prune-event timeline per rung (the blr_arch x8 recipe fires
# kills on DeiT-S; this records whether it does on Swin too)
for FRAC in $TARGETS; do
  EXP="$EXP_ROOT/t$FRAC"
  [ -f "$EXP/search.log" ] && python -m ofb_tpu_torch.scripts.prune_timeline \
      "$EXP/search.log" --log-txt "$EXP/log.txt" \
      --json-out "$EXP/prune_timeline.json" || true
done

echo "=== swin ladder complete; per-target logs under $EXP_ROOT ==="
