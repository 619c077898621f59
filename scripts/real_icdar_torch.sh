#!/usr/bin/env bash
# The port's one-command real-ICDAR rehearsal: data layout -> (optional
# warm start) -> train -> test submission files -> ICDAR P/R/F, on the
# PyTorch port (tensorflow_ocr_tpu_torch); scripts/real_icdar.sh is the
# same pipeline on the JAX package.
#
#   scripts/real_icdar_torch.sh /data/ocr/icdar2015/train \
#       /data/ocr/icdar2015/test /data/ocr/icdar2015/test_gt \
#       [/data/ocr/resnet_v1_50.npz] [60000]
#
# With no arguments it smoke-tests the identical pipeline on synthetic
# scenes laid out in ICDAR format (img_*.jpg + gt_*.txt) written by the
# port's data/icdar.py, 3 steps at 128^2, batch 2 (override with STEPS as
# the fifth argument, SIZE and BATCH in the environment).
#
# Runs on the GPU unless DEVICE=cpu; --device goes to both entry points.
# CKPT and RES name the checkpoint and result directories, WORK the
# directory that holds them and the smoke data by default (the checkout's
# git-ignored tensorflow_ocr_tpu_torch/build/real_icdar/); PYTHON the
# interpreter. Imports nothing of the JAX package.
set -euo pipefail
cd "$(dirname "$0")/.."

TRAIN_DIR="${1:-}"
TEST_DIR="${2:-}"
GT_DIR="${3:-}"
PRETRAINED="${4:-}"
STEPS="${5:-60000}"

PYTHON="${PYTHON:-python3}"
DEVICE="${DEVICE:-cuda}"
WORK="${WORK:-tensorflow_ocr_tpu_torch/build/real_icdar}"
CKPT="${CKPT:-$WORK/ckpt/}"
RES="${RES:-$WORK/res/}"
SMOKE=0

if [ -z "$TRAIN_DIR" ]; then
  SMOKE=1
  # smoke defaults are small (override with SIZE/BATCH/STEPS): the point
  # is exercising the identical pipeline, not training
  STEPS="${5:-3}"
  SIZE="${SIZE:-128}"
  BATCH="${BATCH:-2}"
  TRAIN_DIR="$WORK/smoke/train"
  TEST_DIR="$WORK/smoke/test"
  GT_DIR="$TEST_DIR"   # synthetic gt lives beside the images
  echo "== smoke mode: synthetic scenes in ICDAR layout, $STEPS steps =="
  "$PYTHON" - <<EOF
from tensorflow_ocr_tpu_torch.data.icdar import make_synthetic_dataset
make_synthetic_dataset("$TRAIN_DIR", 8, ($SIZE, $SIZE), seed=0, hard=True)
make_synthetic_dataset("$TEST_DIR", 4, ($SIZE, $SIZE), seed=1, hard=True)
print("synthetic ICDAR-format data at $TRAIN_DIR / $TEST_DIR")
EOF
fi

rm -rf "$CKPT" "$RES"

WARM_ARGS=()
SIZE="${SIZE:-512}"

if [ -n "$PRETRAINED" ]; then
  # a converted slim .npz (REAL_DATA.md §2); expect "warm-started 265
  # tensors" at startup (0 means the wrong path or family)
  WARM_ARGS=(--pretrained_model_path="$PRETRAINED" --model.freeze_bn=true)
fi

echo "== train: $STEPS steps on $TRAIN_DIR ($DEVICE) =="
"$PYTHON" -m tensorflow_ocr_tpu_torch.cli.multigpu_train \
  --training_data_path="$TRAIN_DIR" \
  --checkpoint_path="$CKPT" \
  --input_size="$SIZE" --batch_size_per_gpu="${BATCH:-8}" \
  --learning_rate=0.0001 --max_steps="$STEPS" \
  --save_checkpoint_steps=0 \
  --device="$DEVICE" \
  ${WARM_ARGS[@]+"${WARM_ARGS[@]}"}

echo "== infer: cli.test (EMA restore) -> $RES =="
"$PYTHON" -m tensorflow_ocr_tpu_torch.cli.test \
  --test_data_path="$TEST_DIR" \
  --checkpoint_path="$CKPT" \
  --output_dir="$RES" \
  --model.name=pixellink_resnet50 \
  --device="$DEVICE"

echo "== eval: ICDAR IoU-0.5 greedy matching =="
"$PYTHON" - <<EOF
from tensorflow_ocr_tpu_torch.eval.metrics import evaluate_icdar_directory
r = evaluate_icdar_directory("$RES", "$GT_DIR")
print({k: round(v, 4) for k, v in r.items()})
EOF

if [ "$SMOKE" = 1 ]; then
  echo "== smoke rehearsal complete (pipeline exercised end to end) =="
  echo "   real run: scripts/real_icdar_torch.sh TRAIN TEST TEST_GT [NPZ] [STEPS]"
fi
