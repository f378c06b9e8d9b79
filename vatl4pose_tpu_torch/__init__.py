"""vatl4pose_tpu_torch — the PyTorch/CUDA port of `vatl4pose_tpu` for one
NVIDIA H100.

The layout mirrors the JAX package: `data/`, `ops/`, `models/`,
`kernels/` (hand-written CUDA kernels, sources under `csrc/`, built with
nvcc at first use) and `al/`.  The package imports torch, numpy and scipy,
never jax, flax or anything of `vatl4pose_tpu`.

Entry points take `device=None`, which means CUDA; without a card they
raise unless the caller asks for `"cpu"` (see `device.resolve_device`).
"""

__version__ = "0.1.0"
