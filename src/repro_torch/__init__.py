"""PyTorch/CUDA port of the EGRL memory-placement system.

A second package beside the JAX reference in ``src/repro``: it imports
``torch`` and numpy, never ``jax`` and never a module of ``repro``.
Entry points take ``device`` (default ``"cuda"``) and raise when CUDA
is missing unless the caller passes ``device="cpu"``.  On CUDA tensors
the two hot loops run hand-written kernels (``csrc/``); on CPU tensors
they run the plain PyTorch versions kept beside them.
"""
