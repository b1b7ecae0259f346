#!/usr/bin/env bash
# Accuracy-vs-FLOPs ladder at REGISTRY GEOMETRY on a file-based ImageFolder
# (the OFB-DeiT-A..E analog at full DeiT-S/224 scale — reference
# README.md:19-25, run_exp.sh:10; ladder.py is the digits-scale version of
# the same deliverable). Port of scripts/ladder_imnet.sh: the same stages,
# skips, resumes and knobs, through the port's CLIs.
#
# For each FLOPs target: two-stage search (fuse@50, reference cadence) then
# export + finetune, all through the real CLIs, fed from the on-device
# dataset cache (--cache-device) as CUDA-graph epochs (--planned-epoch).
#
# RESUMABLE: each stage checks its output's checkpoint meta and is skipped
# when already complete, or resumed from running_ckpt when partially done
# (a dead rung does not re-pay all its epochs).
#
# Beside the JAX script's knobs: DEVICE (passed as --device to every CLI;
# cuda raises without a card), DATA_SET (the CLIs' --data-set) and one
# variable of extra flags for each CLI, SEARCH_EXTRA (both search stages)
# and FINETUNE_EXTRA (the rungs' and the dense comparator's finetunes),
# e.g. "--synthetic-size 256".
#
# Usage: DATA=/tmp/imfolder bash ofb_tpu_torch/scripts/ladder_imnet.sh \
#            runs/ladder_imnet
set -euo pipefail

EXP_ROOT=${1:-runs/ladder_imnet}
DATA=${DATA:-/tmp/imfolder}
DATA_SET=${DATA_SET:-IMNET}
DEVICE=${DEVICE:-cuda}
MODEL=${MODEL:-deit_small_patch16_224_mim}
EPOCHS=${EPOCHS:-100}
FUSE_POINT=${FUSE_POINT:-50}
BATCH=${BATCH:-256}
FT_EPOCHS=${FT_EPOCHS:-60}
# model_flops() dense term of the supernet: deit_small 4.600 (default),
# deit_tiny 1.366, deit_base 17.525 — override when MODEL changes
DENSE_GFLOPS=${DENSE_GFLOPS:-4.600}
# Rungs straddle the ~0.44x-dense expected FLOPs of the uniform-alpha
# init, spanning the reference ladder's A..D range (README.md:19-25:
# 0.9-3.4 GFLOPs on tiny/small): 0.25 pulls hard down, 0.45 holds, 0.70
# pulls up (keep more).
TARGETS=${TARGETS:-"0.25 0.45 0.70"}
# w_flops must be large enough that the FLOPs *selector* competes with
# the variance-term *amplifier* at this step count (16x shorter than the
# reference's 125k); see BENCH.md "Why targets collapse to one attractor".
W_FLOPS=${W_FLOPS:-2000}
# arch LR scaled to the subset step deficit so organic kills fire inside
# the run (BENCH.md round 4 "Measured alpha-sharpening rate"); export
# BLR_ARCH=2.5e-4 for the reference default.
BLR_ARCH=${BLR_ARCH:-2e-3}
# extra flags for both search stages (e.g. the organic recipe:
# "--model-ema --ckpt-every 10 --eval-every 5"); FT_FROM picks the export
# source — `best` (eval winner) or `running_ckpt` (final state; the right
# choice for organic runs, where convergence accumulates to the end and
# the saturated train-val makes `best` an early-epoch snapshot).
SEARCH_EXTRA=${SEARCH_EXTRA:-}
FINETUNE_EXTRA=${FINETUNE_EXTRA:-}
FT_FROM=${FT_FROM:-best}
cd "$(dirname "$0")/../.."
mkdir -p "$EXP_ROOT"

# ckpt_epoch <dir>: epoch recorded in a checkpoint meta, or -1
ckpt_epoch() {
  python - "$1" <<'PY'
import json, os, sys
p = os.path.join(sys.argv[1], "meta.json")
print(json.load(open(p)).get("epoch", -1) if os.path.exists(p) else -1)
PY
}

for FRAC in $TARGETS; do
  TGT=$(python -c "print(f'{$DENSE_GFLOPS * $FRAC:.3f}')")
  EXP="$EXP_ROOT/t$FRAC"
  mkdir -p "$EXP"
  echo "=== target $FRAC x dense = $TGT GFLOPs -> $EXP ==="
  SEARCH_EP=$(ckpt_epoch "$EXP/running_ckpt")

  # stage 1: search to the fuse point (reference run_exp.sh:15)
  if [ "$SEARCH_EP" -ge "$((FUSE_POINT - 1))" ]; then
    echo "--- stage 1 complete (epoch $SEARCH_EP), skipping"
  else
    RESUME=""
    if [ "$SEARCH_EP" -ge 0 ]; then
      RESUME="--resume --checkpoint $EXP/running_ckpt"
      echo "--- stage 1 resuming from epoch $SEARCH_EP"
    fi
    python -m ofb_tpu_torch.cli.search --data-path "$DATA" \
        --data-set "$DATA_SET" --device "$DEVICE" \
        --model "$MODEL" --target_flops "$TGT" \
        --epochs "$EPOCHS" --fuse_point "$FUSE_POINT" --batch-size "$BATCH" \
        --w_flops "$W_FLOPS" --blr_arch "$BLR_ARCH" \
        --accum-iter 1 --cache-device --planned-epoch --output_dir "$EXP" \
        $SEARCH_EXTRA $RESUME 2>&1 | tee -a "$EXP/search1.log"
  fi

  # stage 2: resume for the remaining epochs (reference run_exp.sh:17)
  SEARCH_EP=$(ckpt_epoch "$EXP/running_ckpt")
  if [ "$SEARCH_EP" -ge "$((EPOCHS - 1))" ]; then
    echo "--- stage 2 complete (epoch $SEARCH_EP), skipping"
  else
    python -m ofb_tpu_torch.cli.search --data-path "$DATA" \
        --data-set "$DATA_SET" --device "$DEVICE" \
        --model "$MODEL" --target_flops "$TGT" \
        --epochs "$EPOCHS" --fuse_point "$EPOCHS" --batch-size "$BATCH" \
        --w_flops "$W_FLOPS" --blr_arch "$BLR_ARCH" \
        --accum-iter 1 --cache-device --planned-epoch --output_dir "$EXP" \
        $SEARCH_EXTRA --resume --checkpoint "$EXP/running_ckpt" \
        2>&1 | tee -a "$EXP/search2.log"
  fi

  # stage 3: export + finetune (reference run_exp.sh:22)
  FT_EP=$(ckpt_epoch "$EXP/ft/running_ckpt")
  if [ "$FT_EP" -ge "$((FT_EPOCHS - 1))" ]; then
    echo "--- finetune complete (epoch $FT_EP), skipping"
  else
    python -m ofb_tpu_torch.cli.finetune --data-path "$DATA" \
        --data-set "$DATA_SET" --device "$DEVICE" \
        --finetune "$EXP/$FT_FROM" --epochs "$FT_EPOCHS" --batch-size "$BATCH" \
        --cache-device --planned-epoch --output_dir "$EXP/ft" \
        $FINETUNE_EXTRA 2>&1 | tee -a "$EXP/finetune.log"
  fi
  python -m ofb_tpu_torch.scripts.run_status --root "$EXP_ROOT" >/dev/null || true
done

# dense comparator: the SAME finetune recipe from a fresh dense init
# (ladder_imnet_summary reads it from <root>/dense_ft/best)
DENSE_MODEL=${DENSE_MODEL:-${MODEL/_mim/_finetune}}
if [ ! -f "$EXP_ROOT/dense_ft/best/meta.json" ]; then
  python -m ofb_tpu_torch.cli.finetune --data-path "$DATA" \
      --data-set "$DATA_SET" --device "$DEVICE" \
      --model "$DENSE_MODEL" --from-scratch \
      --epochs "$FT_EPOCHS" --batch-size "$BATCH" \
      --cache-device --planned-epoch --output_dir "$EXP_ROOT/dense_ft" \
      $FINETUNE_EXTRA 2>&1 | tee "$EXP_ROOT/dense_ft.log"
fi

python -m ofb_tpu_torch.scripts.ladder_imnet_summary --root "$EXP_ROOT" \
    2>&1 | tee "$EXP_ROOT/summary.log"
python -m ofb_tpu_torch.scripts.run_status --root "$EXP_ROOT" || true

echo "=== ladder complete; per-target logs under $EXP_ROOT ==="
