"""repro_torch.kernels — hand-written Hopper kernels for the compute hot-spots.

Each kernel ships CUDA sources under ``csrc/``, the module that builds,
binds and launches them (``<name>.py``), the plain PyTorch version
(``ref.py``) and the model-layout wrappers (``ops.py``). A wrapper launches
its kernel for CUDA tensors and takes the plain version only for CPU
tensors. Import the callables from their defining modules
(``repro_torch.kernels.matmul.ops``): this package re-exports nothing, so
the ``matmul`` subpackage is never shadowed by the like-named function.

Ported: the blocked GEMM (``matmul``). Flash attention and the Mamba-2 SSD
scan come with later slices of the port.
"""
