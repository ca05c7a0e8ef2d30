#!/bin/bash
# The TensoIR-synthetic suite of eval_tsir.sh on the PyTorch/CUDA port
# (geosplatting_tpu_torch). Per scene: stage 1 -> stage 2 -> stage 3 (each a
# resumable task chained by its run's export.npz), then the relight
# evaluation, which writes eval.json into the stage-3 run. Runs on the GPU.
set -e
DATA_ROOT=${DATA_ROOT:-data/tensoir}
# a scene whose files are OpenEXR decodes only when this is set before cv2
# is imported (the TensoIR frames are PNG)
export OPENCV_IO_ENABLE_OPENEXR=${OPENCV_IO_ENABLE_OPENEXR:-1}

latest() { ls -dt outputs/$1/*/ | head -1; }

for scene in armadillo ficus hotdog lego; do
  data="$DATA_ROOT/$scene"
  python -m geosplatting_tpu_torch.scripts.train_geosplat "tsir-$scene" --dataset_path "$data"
  python -m geosplatting_tpu_torch.scripts.train_geosplat_mc "tsir-$scene" --dataset_path "$data" \
    --load "$(latest geosplat-tsir-$scene)"
  python -m geosplatting_tpu_torch.scripts.train_geosplat_defer "tsir-$scene" --dataset_path "$data" \
    --load "$(latest geosplat-mc-tsir-$scene)"
  python -m geosplatting_tpu_torch.scripts.train_geosplat_defer reliteval --dataset_path "$data" \
    --load "$(latest geosplat-defer-tsir-$scene)" --skip_nvs true
done
