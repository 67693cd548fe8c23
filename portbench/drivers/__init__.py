"""One driver per entry kind, found by the name a traffic file gives.

A driver is a class ``Driver(config, traffic, *, seed, device, tracer,
calls)`` with ``unit_size`` (verdicts a unit attempts), ``setup()``,
``unit()`` (one whole unit of work: a list of ``harness.Verdict``),
``release()`` (frees the program's state) and ``check(control)`` (the
numbers compared, each with its limit).
"""
