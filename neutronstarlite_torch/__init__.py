"""neutronstarlite_torch — the PyTorch/CUDA port of neutronstarlite_tpu.

The JAX package ``neutronstarlite_tpu`` is the reference; this package runs
the same workloads on an NVIDIA H100 with PyTorch, and its two aggregation
kernels are hand-written CUDA C++ for Hopper (``csrc/``). It imports
neither jax nor anything of the JAX package: what it needs from that
package's host modules it keeps as its own copy.

It trains the single-device full-batch families: GCN (both orders), GAT,
GIN, CommNet and GGCN:

    python -m neutronstarlite_torch.run <file.cfg> [--device cpu|cuda]
"""

__version__ = "0.1.0"
