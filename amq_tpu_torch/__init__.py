"""PyTorch/CUDA port of the AMQ serving path: mixed-bit decode on an NVIDIA H100.

The JAX package stays the reference; this package reads its
storage layout as is (pair-planar packed codes, transposed per-group
scale/zero) and replaces each Pallas kernel on the serving path with a
CUDA C++ kernel for ``sm_90a`` (``csrc/``).  It imports ``torch``, never
``jax``, and nothing of the JAX package.
"""
