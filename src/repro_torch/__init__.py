"""MorphServe in PyTorch + CUDA: the port of the JAX package ``repro``.

Mirrors ``repro``'s subpackage layout (configs, quant, models, kernels,
core, engine) and its layouts at every public function. Imports torch and
never jax or ``repro``; the two packages meet only in the tests (through
numpy arrays, see :mod:`repro_torch.bridge`). Entry points take an explicit
``device`` (default ``"cuda"``) and run there; the kernel routes launch the
hand-written CUDA kernels on CUDA tensors and their plain torch versions on
CPU tensors.
"""
