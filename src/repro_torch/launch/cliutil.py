"""Shared CLI plumbing for the launch surfaces — one definition per flag.

Every fsck route of the port (``census fsck``, ``queue fsck`` and the
standalone ``fsck`` of ``python -m repro_torch``) registers the same flag
set and dispatches to the same entry point, as in the reference's
``repro.launch.cliutil``. The ``--device`` flag of the commands that
measure is defined here once as well.
"""

from __future__ import annotations

import argparse


def add_fsck_args(p: argparse.ArgumentParser) -> None:
    """THE fsck flag set. Every fsck route — the sub-surface ``fsck``
    verbs and the standalone ``repro_torch fsck`` — registers exactly
    these options and dispatches to :func:`fsck_command`."""
    p.add_argument("--out", required=True, help="store root to check")
    p.add_argument("--dry-run", action="store_true",
                   help="classify and report only; change nothing")


def fsck_command(args: argparse.Namespace) -> int:
    """The one fsck entry all routes share (lazy import keeps ``--help``
    cheap)."""
    from repro_torch.launch.fsck import run_fsck

    return run_fsck(args.out, dry_run=args.dry_run)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    """``--device``: where wall-clock workloads are built and timed. The
    deterministic backends touch no device, so it matters only to them."""
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device the wall-clock backend builds and times its "
                   "workloads on (default cuda; one worker per visible GPU); "
                   "cost_model and simulated censuses touch no device")
