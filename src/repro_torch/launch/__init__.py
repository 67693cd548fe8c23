"""repro_torch.launch — the port's command-line surfaces: the census
(:mod:`.sweep`), the pull-based work queue (:mod:`.queue`), store repair
(:mod:`.fsck`) and the umbrella entry point (:mod:`.cli`,
``python -m repro_torch``)."""
