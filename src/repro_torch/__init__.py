"""PyTorch/CUDA port of the FibecFed system (``repro``, the JAX package, is
its reference). Imports ``torch`` and numpy, never JAX or ``repro``."""
