"""The blocked GEMM: CUDA kernel (``matmul.py`` + ``csrc/gemm.cu``), plain
version (``ref.py``) and wrappers (``ops.py``)."""
