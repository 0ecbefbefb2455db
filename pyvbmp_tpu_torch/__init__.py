"""pyvbmp_tpu_torch: the PyTorch and CUDA port of pyvbmp_tpu.

The JAX package ``pyvbmp_tpu`` is the reference this package is checked
against.  This package imports torch and numpy, never jax.
"""
