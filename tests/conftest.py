"""Test-process configuration.

Distributed system tests (test_distributed, test_system) need a small
multi-device host platform; the flag must be set before jax initialises its
backend, which pytest's collection order cannot guarantee module-side. This
is 8 devices for sharding tests — NOT the dry-run's 512, which is set only
inside ``repro.launch.dryrun`` (smoke tests and benches must not see 512).
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one (run: pytest -m cuda)"
    )
