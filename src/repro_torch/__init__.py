"""PyTorch/CUDA port of the Totoro+ FL system.

Mirrors ``repro``'s module paths (``repro_torch/core/api.py`` answers to
``repro/core/api.py``) and imports neither ``jax`` nor ``repro``.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
every hand-written kernel lives under ``kernels/csrc`` and is compiled for
``sm_90a`` at first use.
"""
