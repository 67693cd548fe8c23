"""repro_torch.kernels — hand-written Hopper kernels for the compute hot-spots.

Each kernel ships CUDA sources under ``csrc/``, the module that checks
what they do not take and declares their host side (``<name>.py``, its
``KERNEL``), the plain PyTorch version (``ref.py``) and the model-layout
wrappers (``ops.py``). A wrapper launches its kernel for CUDA tensors and
takes the plain version only for CPU tensors. Import the callables from
their defining modules (``repro_torch.kernels.matmul.ops``): this package
re-exports nothing, so the ``matmul`` subpackage is never shadowed by the
like-named function.

Ported, each as CUDA C++ for ``sm_90a`` built with nvcc, bound with
``ctypes``, launched on PyTorch's stream and counted by one
:class:`repro_torch.kernels.build.HandKernel`: the blocked GEMM
(``matmul``), flash attention (``flash_attention``) and the Mamba-2 SSD
chunk scan (``ssd``, entry point ``ssd.ops.ssd_mix``) — every TPU kernel
of the reference.
"""
