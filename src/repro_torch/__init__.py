"""repro_torch — the PyTorch / NVIDIA H100 port of ``repro``.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``, and keeps its
own copy of every module it needs. Module names mirror the reference's, so
``repro_torch.core.ranking`` is the counterpart of ``repro.core.ranking``.

Entry points take an explicit ``device=`` (default ``"cuda"``) and raise
when no CUDA device is present; they never carry on on the CPU. Only the
tests pass ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.
"""
