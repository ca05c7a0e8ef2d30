"""Frozen copy of the port's stages 2 and 3, run on its plain PyTorch path.

The benchmark's reference: the modules of ``geosplatting_tpu_torch`` that a
stage-2 (``GeoSplatterMC``) and a stage-3 (``GeoSplatterDefer``) train step
and the relight render reach, copied whole, with two changes. ``_kernels``
keeps only ``resolve_device``; the compositing passes (K1, K2) and the row
prefix sum (K3) always run their plain versions (``ops/rasterize_pairs.py``,
``ops/segment_rows.py``), on whatever device the tensors live. Nothing here
imports the port, so a later change to the port is held against this copy.
"""
