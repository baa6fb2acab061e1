"""GreenDyGNN on PyTorch and CUDA: the port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout module for module, imports
``torch`` and numpy but never ``jax`` or ``repro``, and replaces each
Pallas kernel on its path with a CUDA kernel written for ``sm_90a``
(``kernels/csrc``). Entry points take ``device="cuda"`` by default and
raise where there is no GPU; the CPU tests pass ``device="cpu"``.
"""
