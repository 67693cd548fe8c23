"""One reader per per-layer metric: ``read(run) -> value or None``.

``run`` is a ``harness.RunData``. A reader that finds nothing to read
returns None, and the metric is left out of the result line.
"""
