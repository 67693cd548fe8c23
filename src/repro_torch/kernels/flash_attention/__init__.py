"""Flash attention: CUDA kernel (``flash_attention.py`` +
``csrc/flash_attention.cu``), plain versions (``ref.py``) and the
model-layout wrapper (``ops.py``)."""
