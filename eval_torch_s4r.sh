#!/bin/bash
# The Synthetic4Relight suite of eval_s4r.sh on the PyTorch/CUDA port
# (geosplatting_tpu_torch). Per scene: stage 1 -> stage 2 -> stage 3 (each a
# resumable task chained by its run's export.npz), then the relight
# evaluation, which writes eval.json into the stage-3 run. Runs on the GPU.
set -e
DATA_ROOT=${DATA_ROOT:-data/Synthetic4Relight}
# the scenes store their frames and light probes as OpenEXR, which OpenCV
# decodes only when this is set before cv2 is imported
export OPENCV_IO_ENABLE_OPENEXR=${OPENCV_IO_ENABLE_OPENEXR:-1}

latest() { ls -dt outputs/$1/*/ | head -1; }

for scene in air_baloons chair hotdog jugs; do
  data="$DATA_ROOT/$scene"
  python -m geosplatting_tpu_torch.scripts.train_geosplat "s4r-$scene" --dataset_path "$data"
  python -m geosplatting_tpu_torch.scripts.train_geosplat_mc "s4r-$scene" --dataset_path "$data" \
    --load "$(latest geosplat-s4r-$scene)"
  python -m geosplatting_tpu_torch.scripts.train_geosplat_defer "s4r-$scene" --dataset_path "$data" \
    --load "$(latest geosplat-mc-s4r-$scene)"
  python -m geosplatting_tpu_torch.scripts.train_geosplat_defer reliteval --dataset_path "$data" \
    --load "$(latest geosplat-defer-s4r-$scene)" --skip_nvs true
done
