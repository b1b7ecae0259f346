#!/usr/bin/env bash
# Two-stage OFB pipeline (reference exp_sh/run_exp.sh), port of
# scripts/run_exp.sh through the port's CLIs:
#   stage 1: search until fuse_point, fuse the best supernet
#   stage 2: resume the (fused) search for the remaining epochs
#   stage 3: export + finetune the discovered subnet
#
# Beside the JAX script's knobs: DEVICE (passed as --device to every CLI;
# cuda raises without a card), DATA_SET (the CLIs' --data-set) and one
# variable of extra flags for each CLI: SEARCH_EXTRA (both search stages),
# EXPORT_EXTRA and FINETUNE_EXTRA (after the script's own flags, so
# "--epochs 1" there overrides the finetune's 300).
#
# Usage: DATA=/path/to/imagenet bash ofb_tpu_torch/scripts/run_exp.sh runs/exp
set -euo pipefail

EXP=${1:-runs/exp}
DATA=${DATA:-/data/imagenet}
DATA_SET=${DATA_SET:-IMNET}
DEVICE=${DEVICE:-cuda}
MODEL=${MODEL:-deit_small_patch16_224_mim}
TARGET_FLOPS=${TARGET_FLOPS:-1.0}
EPOCHS=${EPOCHS:-100}
FUSE_POINT=${FUSE_POINT:-50}
BATCH=${BATCH:-128}
SEARCH_EXTRA=${SEARCH_EXTRA:-}
EXPORT_EXTRA=${EXPORT_EXTRA:-}
FINETUNE_EXTRA=${FINETUNE_EXTRA:-}
cd "$(dirname "$0")/../.."

# stage 1: search to the fuse point (reference run_exp.sh:15)
python -m ofb_tpu_torch.cli.search --data-path "$DATA" \
    --data-set "$DATA_SET" --device "$DEVICE" \
    --model "$MODEL" --target_flops "$TARGET_FLOPS" \
    --epochs "$EPOCHS" --fuse_point "$FUSE_POINT" --batch-size "$BATCH" \
    --output_dir "$EXP" $SEARCH_EXTRA 2>&1 | tee "$EXP-Search.log"

# stage 2: resume from the running checkpoint for the remaining epochs
# (reference run_exp.sh:17)
python -m ofb_tpu_torch.cli.search --data-path "$DATA" \
    --data-set "$DATA_SET" --device "$DEVICE" \
    --model "$MODEL" --target_flops "$TARGET_FLOPS" \
    --epochs "$EPOCHS" --fuse_point "$EPOCHS" --batch-size "$BATCH" \
    --output_dir "$EXP" --resume --checkpoint "$EXP/running_ckpt" \
    $SEARCH_EXTRA 2>&1 | tee -a "$EXP-Search.log"

# stage 3: export + finetune (reference run_exp.sh:22)
python -m ofb_tpu_torch.cli.export --checkpoint "$EXP/best" \
    --out "$EXP/exported" --model "$MODEL" --device "$DEVICE" $EXPORT_EXTRA
python -m ofb_tpu_torch.cli.finetune --data-path "$DATA" \
    --data-set "$DATA_SET" --device "$DEVICE" \
    --finetune "$EXP/exported" --epochs 300 --batch-size "$BATCH" \
    --output_dir "$EXP-ft" $FINETUNE_EXTRA 2>&1 | tee "$EXP-Finetune.log"
