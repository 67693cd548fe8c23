"""repro_torch.models — the model code the port has so far.

``attention`` (the attention variants, decode and the KV-cache helpers),
``mamba2`` (the SSD scans) and ``layers.softcap``: the oracles of the
flash-attention and SSD kernels and the bodies of the ``attention_impl`` and
``ssd_chunk`` autotune sites. Parameters, projections and the model stack
come with a later slice. Import from the defining modules.
"""
