"""PyTorch/CUDA port of the ``repro`` serving system.

The package mirrors ``repro``'s layout and names (``models``, ``kernels``,
``serving``, ``data``, ``core``, ``configs``) and imports neither JAX nor
anything from ``repro``: what it needs of the framework-free modules there
it keeps as its own copies.  Entry points run on CUDA unless the caller
passes ``device="cpu"``; the hand-written kernels under
``repro_torch.kernels`` run on CUDA tensors, and their plain PyTorch
versions on CPU tensors.
"""
