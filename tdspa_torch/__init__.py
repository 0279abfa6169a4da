"""tdspa_torch: the 3DSPA framework on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``tdspa`` that mirrors its layout module for module
(``core/``, ``kernels/``, ``models/``, ``ops/``, ``data/``, ``features/``,
``infer/``, ``utils/``). Plain tensor code is PyTorch; the TPU's Pallas
kernels become CUDA kernels written by hand for ``sm_90a`` under
``tdspa_torch/csrc/``, built with ``nvcc`` at first use.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; without a GPU they raise rather than fall back.
"""
