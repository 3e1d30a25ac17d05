"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and their tree wrappers (``ops``). Building a kernel happens at
its first launch, never at import."""
