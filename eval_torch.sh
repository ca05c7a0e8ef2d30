#!/bin/bash
# The 3-stage chain of eval.sh on the PyTorch/CUDA port (geosplatting_tpu_torch):
# each stage is a resumable task whose hand-off is its run's export.npz;
# reliteval writes eval.json into the stage-3 run. Runs on the GPU; append
# e.g. "--device cpu --resolution 10 --scale_factor 0.04" to a stage for a
# tiny CPU run.
set -e
SCENE=${1:-hotdog}
DATA=${2:-data/Synthetic4Relight/$SCENE}
# Synthetic4Relight stores its frames and light probes as OpenEXR, which
# OpenCV decodes only when this is set before cv2 is imported
export OPENCV_IO_ENABLE_OPENEXR=${OPENCV_IO_ENABLE_OPENEXR:-1}

latest() { ls -dt outputs/$1/*/ | head -1; }

python -m geosplatting_tpu_torch.scripts.train_geosplat "s4r-$SCENE" --dataset_path "$DATA"
python -m geosplatting_tpu_torch.scripts.train_geosplat_mc "s4r-$SCENE" --dataset_path "$DATA" \
  --load "$(latest geosplat-s4r-$SCENE)"
python -m geosplatting_tpu_torch.scripts.train_geosplat_defer "s4r-$SCENE" --dataset_path "$DATA" \
  --load "$(latest geosplat-mc-s4r-$SCENE)"
python -m geosplatting_tpu_torch.scripts.train_geosplat_defer reliteval --dataset_path "$DATA" \
  --load "$(latest geosplat-defer-s4r-$SCENE)"
