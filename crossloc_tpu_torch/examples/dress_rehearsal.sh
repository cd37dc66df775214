#!/bin/bash
# One-command dress rehearsal of the FULL CrossLoc experiment matrix through
# the unchanged bash harness on the PyTorch port (counterpart of
# examples/dress_rehearsal.sh), on a synthesized dataset in the exact
# reference directory layout (all modalities incl. semantics + eye).
#
# Flow (reference workflow, `notes_crossloc_full_steps.md` analog):
#   synthesize dataset
#   -> encoder_pretrain      (coord, depth, normal, semantics)
#   -> validate_encoder_pretrain + select_ckpt      (val_sim sweep, FLAG)
#   -> encoder_finetune      (coord, pairwise sim-to-real)
#   -> decoder_finetune_plus_semantics  (4 MLR encoders)
#   -> validate_decoder_finetune + select_ckpt      (val_drone_real sweep)
#   -> framework-extension arms: --e2e_pose_loss, mid-training kill +
#      exact full-state resume (--ckpt_backend msgpack), out-of-place
#      real-only domain pass (encoder_pretrain_real_only.sh analog of
#      decoder_finetune_real_only.sh:167)
#
# Tiny config: 96x144 images, --tiny nets, 1 epoch each (minutes on the
# card; the CPU run is slow).
# Usage: bash crossloc_tpu_torch/examples/dress_rehearsal.sh [workdir] [device]
#   workdir default: mktemp -d; device: cuda (default) or cpu, passed to every
#   CLI as --device
set -euo pipefail

REPO=$(cd "$(dirname "$0")/../.." && pwd)
WS=${1:-$(mktemp -d "${TMPDIR:-/tmp}/crossloc_rehearsal.XXXX")}
DEVICE=${2:-cuda}
echo "== dress rehearsal in $WS on $DEVICE"
mkdir -p "$WS" && cd "$WS"
# the heredocs below import the port from the repository
export PYTHONPATH="$REPO"

# the harness invokes `python3 train_single_task.py` relative to the CWD,
# exactly like the reference scripts: link the port's shims into the
# workspace so outputs land here, not in the repo
for shim in train_single_task.py finetune_decoder_single_task.py \
            test_single_task.py visualize.py; do
  ln -sf "$REPO/crossloc_tpu_torch/harness/$shim" "$WS/$shim"
done
SELECT="$REPO/crossloc_tpu_torch/harness/select_ckpt.py"

echo "== 1. synthesize dataset (reference directory contract, all modalities)"
python3 - <<PY
from crossloc_tpu_torch import data
for sec, seed in [("train_sim", 0), ("val_sim", 1),
                  ("train_drone_real", 2), ("train_drone_sim", 3),
                  ("val_drone_real", 4)]:
    data.write_fake_dataset(f"datasets/urbanscape/{sec}", n=4,
                            img_h=96, img_w=144, focal=120.0, seed=seed)
print("dataset ready")
PY

TRAIN_EXTRA="--epochs 1 --batch_size 2 --datasets_dir $WS/datasets --image_height 96 --device $DEVICE"
VAL_EXTRA="--batch_size 2 --datasets_dir $WS/datasets --image_height 96 --device $DEVICE"
export EXTRA_ARGS="$TRAIN_EXTRA"
export CKPT_DIR=$WS/ckpts

echo "== 2. encoder pretraining (4 tasks)"
for TASK in coord depth normal; do
  bash "$REPO/script_clean_training/encoder_pretrain.sh" urbanscape $TASK TINY 1.0 in_place 0.0 MLE 0
done
bash "$REPO/script_clean_training/encoder_pretrain.sh" urbanscape semantics TINY 1.0 in_place 0.0 NONE 0

echo "== 3. validate pretraining checkpoints on val_sim + select"
for TASK in coord depth normal; do
  PT_DIR=$CKPT_DIR/urbanscape-${TASK}-sclean_training-unc-MLE-e1-lr0.0002-sim_only-sc1.00-tiny
  MIN_CKPT_ITER=0 CKPT_DIR=$PT_DIR EXTRA_ARGS="$VAL_EXTRA" \
    bash "$REPO/script_clean_validation/validate_encoder_pretrain.sh" urbanscape $TASK TINY MLE 0
  (cd "$PT_DIR" && python3 "$SELECT" --task $TASK)
  ls "$PT_DIR"/FLAG_SELECTED_ITER_*.nodata >/dev/null
done

echo "== 4. encoder fine-tuning (coord, pairwise in-place)"
PRETRAIN_OUT=$WS/output/urbanscape-coord-sclean_training-unc-MLE-e1-lr0.0002-sim_only-sc1.00-tiny
ENC_PRETRAINED=$PRETRAIN_OUT/model.net \
  bash "$REPO/script_clean_training/encoder_finetune.sh" urbanscape coord TINY 0.0 in_place 1.0 MLE 0

echo "== 5. decoder fine-tuning with 4 MLR encoders (+semantics)"
FT_OUT=$WS/output/urbanscape-coord-sclean_training_ip-unc-MLE-e1-lr0.0001-pairs-ip-rc1.00-tiny-finetune
ENC_COORD=$FT_OUT/model_resume.net \
ENC_DEPTH=$WS/output/urbanscape-depth-sclean_training-unc-MLE-e1-lr0.0002-sim_only-sc1.00-tiny/model.net \
ENC_NORMAL=$WS/output/urbanscape-normal-sclean_training-unc-MLE-e1-lr0.0002-sim_only-sc1.00-tiny/model.net \
ENC_SEMANTICS=$WS/output/urbanscape-semantics-sclean_training-no_unc-fullsize-e1-lr0.0002-sim_only-sc1.00-tiny/model.net \
  bash "$REPO/script_clean_training/decoder_finetune_plus_semantics.sh" urbanscape coord TINY 1.0 in_place 1.0 MLE 0

echo "== 6. validate decoder checkpoints on val_drone_real + select"
DEC_DIR=$CKPT_DIR/$(basename "$(ls -d $WS/output/urbanscape-coord-decoder_* | head -1)")
MIN_CKPT_ITER=0 CKPT_DIR=$DEC_DIR EXTRA_ARGS="$VAL_EXTRA" \
  bash "$REPO/script_clean_validation/validate_decoder_finetune.sh" urbanscape coord TINY MLE 0
(cd "$DEC_DIR" && python3 "$SELECT" --task coord)

echo "== 7. assertions"
for f in \
  "$PRETRAIN_OUT/FLAG_training_done.nodata" \
  "$FT_OUT/FLAG_training_done.nodata" \
  "$DEC_DIR"/FLAG_SELECTED_ITER_*.nodata \
  "$DEC_DIR"/results_overall.txt; do
  ls $f >/dev/null || { echo "MISSING: $f"; exit 1; }
done

echo "== 8. framework-extension arms"

echo "== 8a. DSAC end-to-end pose-loss arm (--e2e_pose_loss)"
EXTRA_ARGS="$TRAIN_EXTRA --e2e_pose_loss --e2e_warmup_epochs 0" \
  bash "$REPO/script_clean_training/encoder_pretrain.sh" urbanscape coord TINY 1.0 in_place 0.0 NONE 0
E2E_OUT=$WS/output/urbanscape-coord-sclean_training-no_unc-e2e-e1-lr0.0002-sim_only-sc1.00-tiny
ls "$E2E_OUT/FLAG_training_done.nodata" >/dev/null || { echo "MISSING e2e FLAG"; exit 1; }
grep -q "Total loss" "$E2E_OUT/output.log" || { echo "e2e arm logged no loss"; exit 1; }

echo "== 8b. mid-training kill + exact full-state resume (--ckpt_backend msgpack)"
# 40 epochs so the kill provably lands mid-run: the first .state appears
# after epoch 0 and ~39 epochs (tens of seconds) remain when we react
RESUME_ARGS="--epochs 40 --batch_size 2 --datasets_dir $WS/datasets --image_height 96 \
  --ckpt_backend msgpack --session resume_arm --device $DEVICE"
RES_OUT=$WS/output/urbanscape-coord-sresume_arm-no_unc-e40-lr0.0002-sim_only-sc1.00-tiny
# kill as soon as the first epoch's .state lands (direct PIDs only: the
# python CLI is a child of the backgrounded harness bash — no pattern kills)
env EXTRA_ARGS="$RESUME_ARGS" \
  bash "$REPO/script_clean_training/encoder_pretrain.sh" urbanscape coord TINY 1.0 in_place 0.0 NONE 0 \
  > "$WS/resume_arm_phase1.log" 2>&1 &
KPID=$!
for i in $(seq 1 1500); do
  ls "$RES_OUT"/state_*.state >/dev/null 2>&1 && break
  kill -0 $KPID 2>/dev/null || break   # died early: caught by asserts below
  sleep 0.2
done
for c in $(ps -o pid= --ppid $KPID 2>/dev/null); do kill -TERM "$c" 2>/dev/null || true; done
kill -TERM $KPID 2>/dev/null || true
wait $KPID 2>/dev/null || true
ls "$RES_OUT"/state_*.state >/dev/null || { echo "no .state checkpoint before kill"; exit 1; }
# the kill must land MID-RUN, otherwise the resume below verifies nothing
if [ -e "$RES_OUT/FLAG_training_done.nodata" ]; then
  echo "phase 1 completed before the kill — resume arm would be vacuous"; exit 1
fi
# resume: SAME harness command (encoder_pretrain.sh always passes --auto_resume)
EXTRA_ARGS="$RESUME_ARGS" \
  bash "$REPO/script_clean_training/encoder_pretrain.sh" urbanscape coord TINY 1.0 in_place 0.0 NONE 0
grep -q "Restored full train state" "$RES_OUT/output.log" \
  || { echo "resume did not restore the full train state"; exit 1; }
ls "$RES_OUT/FLAG_training_done.nodata" >/dev/null || { echo "MISSING resume FLAG"; exit 1; }

echo "== 8c. out-of-place real-only domain pass (encoder_pretrain_real_only)"
python3 - <<PY
from crossloc_tpu_torch import data
for sec, seed in [("train_oop_drone_real", 5), ("train_oop_drone_sim", 6),
                  ("val_oop_drone_real", 7)]:
    data.write_fake_dataset(f"datasets/urbanscape/{sec}", n=4,
                            img_h=96, img_w=144, focal=120.0, seed=seed)
print("oop sections ready")
PY
EXTRA_ARGS="$TRAIN_EXTRA" \
  bash "$REPO/script_clean_training/encoder_pretrain_real_only.sh" urbanscape coord TINY 0.0 out_of_place 1.0 NONE 0
OOP_OUT=$WS/output/urbanscape-coord-sclean_training-no_unc-e1-lr0.0002-real_only-oop-rc1.00-tiny
ls "$OOP_OUT/FLAG_training_done.nodata" >/dev/null || { echo "MISSING oop FLAG"; exit 1; }

echo "== dress rehearsal PASSED ($WS)"
