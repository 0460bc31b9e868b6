"""PyTorch/CUDA port of the ``repro`` federated-learning system.

The package mirrors ``src/repro`` module for module and is held against it
by the ``tests/test_torch_*.py`` parity tests.  It imports ``torch`` and
``numpy`` only — never ``jax`` and never a module of ``repro``.

Entry points run on a CUDA card unless the caller asks for the CPU
(``--device cpu``); the fused coalition round's two hand-written CUDA
kernels live in :mod:`repro_torch.kernels`.
"""
