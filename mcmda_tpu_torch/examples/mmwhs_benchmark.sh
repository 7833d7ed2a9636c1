#!/usr/bin/env bash
# Full MMWHS benchmark recipe on the PyTorch port (BASELINE configs 1-5,
# both directions): the twin of examples/mmwhs_benchmark.sh.
# Prereq: raw MMWHS 2017 volumes (mr_train_*_image/label.nii.gz,
# ct_train_*_image/label.nii.gz) under $RAW.  DEVICE (default cuda) goes to
# every command; DEVICE=cpu runs the plain PyTorch versions.  The kernel
# paths (segmenter.train_fused, run.use_pallas) are asked for on the
# command lines; the configs are the shipped ones.
set -euo pipefail
RAW=${RAW:-/data/mmwhs_raw}
DATA=${DATA:-/data/mmwhs}
OUT=${OUT:-runs/torch_mri2ct}
DEVICE=${DEVICE:-cuda}
cd "$(dirname "$0")/../.."

# D2/D4: normalize + remap labels + benchmark layout
python -m mcmda_tpu_torch.scripts.preprocess_mmwhs --raw "$RAW" --out "$DATA"

# config 2: supervised source training (20 labeled MRI volumes)
python -m mcmda_tpu_torch train-source --config configs/mri2ct.json \
    --data-root "$DATA" --out "$OUT/src" --device "$DEVICE" \
    --set segmenter.train_fused=pallas

# config 1: source-only lower bound on the 4 held-out CT volumes
python -m mcmda_tpu_torch evaluate --config configs/mri2ct.json \
    --data-root "$DATA" --ckpt "$OUT/src/step_00020000" --source-only \
    --json-out "$OUT/torch_no_adapt.json" --device "$DEVICE" \
    --set run.use_pallas=true

# configs 3+4: critic pretrain + PnP-AdaNet adaptation (16 unlabeled CT)
python -m mcmda_tpu_torch adapt --config configs/mri2ct.json \
    --data-root "$DATA" --source-ckpt "$OUT/src/step_00020000" \
    --out "$OUT/adapt" --device "$DEVICE" \
    --set segmenter.train_fused=pallas

# adapted eval: the headline table.  Passing the RUN DIR resolves through
# selection.json, the unsupervised class-ratio-selected checkpoint
python -m mcmda_tpu_torch evaluate --config configs/mri2ct.json \
    --data-root "$DATA" --ckpt "$OUT/adapt" \
    --json-out "$OUT/torch_adapted.json" --device "$DEVICE" \
    --set run.use_pallas=true

# config 5: reverse direction (plug depth rm2, flip TTA at evaluation)
python -m mcmda_tpu_torch train-source --config configs/ct2mri.json \
    --direction ct2mri --data-root "$DATA" --out "$OUT/../torch_ct2mri/src" \
    --device "$DEVICE" --set segmenter.train_fused=pallas
python -m mcmda_tpu_torch adapt --config configs/ct2mri.json \
    --direction ct2mri --data-root "$DATA" \
    --source-ckpt "$OUT/../torch_ct2mri/src/step_00020000" \
    --out "$OUT/../torch_ct2mri/adapt" --device "$DEVICE" \
    --set segmenter.train_fused=pallas
python -m mcmda_tpu_torch evaluate --config configs/ct2mri.json \
    --direction ct2mri --data-root "$DATA" --ckpt "$OUT/../torch_ct2mri/adapt" \
    --json-out "$OUT/../torch_ct2mri/torch_adapted.json" --device "$DEVICE" \
    --set run.use_pallas=true
