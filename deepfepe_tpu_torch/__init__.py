"""PyTorch port of `deepfepe_tpu` for one NVIDIA H100.

Mirrors the JAX package's module layout (geometry, ops, models, losses,
frontend, eval, data, train, utils, cli). The port imports torch and numpy only;
it never imports jax, flax or `deepfepe_tpu`.

Kernels written by hand for Hopper live under `csrc/` and are built with
`nvcc` at first use (see `utils/build.py`). On a CPU tensor each kernel
wrapper runs its plain PyTorch version; on a CUDA tensor it launches the
kernel or raises.
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
