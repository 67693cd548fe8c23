"""The Mamba-2 SSD chunk scan: CUDA kernel (``ssd.py`` + ``csrc/ssd.cu``),
plain version (``ref.py``) and the mixer-layout wrapper (``ops.py``)."""
