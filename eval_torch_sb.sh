#!/bin/bash
# The Shiny Blender suite of eval_sb.sh on the PyTorch/CUDA port
# (geosplatting_tpu_torch). Per scene: stage 1 -> stage 2 -> stage 3 (each a
# resumable task chained by its run's export.npz), then the novel-view
# evaluation, which writes eval.json into the stage-3 run. Runs on the GPU.
set -e
DATA_ROOT=${DATA_ROOT:-data/refnerf}
# a scene whose files are OpenEXR decodes only when this is set before cv2
# is imported (the Shiny Blender frames are PNG)
export OPENCV_IO_ENABLE_OPENEXR=${OPENCV_IO_ENABLE_OPENEXR:-1}

latest() { ls -dt outputs/$1/*/ | head -1; }

for scene in ball car coffee helmet teapot toaster; do
  data="$DATA_ROOT/$scene"
  python -m geosplatting_tpu_torch.scripts.train_geosplat "sb-$scene" --dataset_path "$data"
  python -m geosplatting_tpu_torch.scripts.train_geosplat_mc "sb-$scene" --dataset_path "$data" \
    --load "$(latest geosplat-sb-$scene)"
  python -m geosplatting_tpu_torch.scripts.train_geosplat_defer "sb-$scene" --dataset_path "$data" \
    --load "$(latest geosplat-mc-sb-$scene)"
  python -m geosplatting_tpu_torch.scripts.train_geosplat_defer nvseval --dataset_path "$data" \
    --load "$(latest geosplat-defer-sb-$scene)"
done
