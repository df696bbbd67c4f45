"""PyTorch/CUDA port of the Domino reproduction, for NVIDIA Hopper cards.

A package of its own beside the JAX package ``repro``, which stays the
reference it is held against. It imports ``torch`` and NumPy, never
``jax`` and nothing of ``repro``: what it needs of the JAX package's
framework-free modules it keeps as its own copies, under the same module
names (``repro_torch.core.program`` is the counterpart of
``repro.core.program``, and so on).

The main path: ``repro_torch.core.program.compile_program`` compiles a
workload, and ``CompiledProgram.executor(weights)`` runs it image → logits
on the card through the hand-written CUDA kernels in ``csrc/``
(``repro_torch.kernels``).
"""
