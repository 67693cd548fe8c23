"""The umbrella CLI: ``python -m repro_torch <surface> <verb> ...``.

One entry point over the port's launch surfaces, as ``python -m repro`` is
the reference's. Each sub-CLI keeps its own parser (registered here, never
duplicated):

    python -m repro_torch census  run --out DIR --workers 4   # DiscriminantSweep
    python -m repro_torch explain run --census DIR --out E    # AnomalyExplainer
    python -m repro_torch queue   work --out DIR              # pull-based drain
    python -m repro_torch fsck    --out DIR [--dry-run]       # repair any store
    python -m repro_torch oracle  warm --out C --census DIR   # ranking service
    python -m repro_torch predict train --census DIR --out M  # learned cost model

The reference's legacy ``python -m repro.launch.X`` aliases have no
counterpart here.

Dispatch is manual (argv[0] lookup, remainder forwarded verbatim) rather
than argparse-subparser composition: every surface's ``main(argv, prog=)``
owns its full argparse tree, and the umbrella just rebrands ``prog`` so
``--help`` prints the command the user actually typed.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional, Tuple


def _census_main(argv: List[str], prog: str) -> int:
    from repro_torch.launch.sweep import main

    return main(argv, prog=prog)


def _queue_main(argv: List[str], prog: str) -> int:
    from repro_torch.launch.queue import main

    return main(argv, prog=prog)


def _fsck_main(argv: List[str], prog: str) -> int:
    from repro_torch.launch.fsck import main

    return main(argv, prog=prog)


def _explain_main(argv: List[str], prog: str) -> int:
    from repro_torch.launch.explain import main

    return main(argv, prog=prog)


def _oracle_main(argv: List[str], prog: str) -> int:
    from repro_torch.launch.oracle import main

    return main(argv, prog=prog)


def _predict_main(argv: List[str], prog: str) -> int:
    from repro_torch.launch.predict import main

    return main(argv, prog=prog)


#: surface name -> (dispatcher, one-line help). Lazy imports keep
#: ``python -m repro_torch --help`` free of every surface's dependency tree.
SURFACES: "dict[str, Tuple[Callable[[List[str], str], int], str]]" = {
    "census": (_census_main,
               "plan/run/merge/report the FLOPs-discriminant census"),
    "explain": (_explain_main,
                "explain the census's anomalies (root-cause campaigns)"),
    "queue": (_queue_main,
              "drain a campaign store with pull-based multi-host workers"),
    "fsck": (_fsck_main,
             "classify/repair/quarantine damage in any campaign store"),
    "oracle": (_oracle_main,
               "warm/query/serve the ranking-as-a-service cache"),
    "predict": (_predict_main,
                "train/apply the learned cost model (active censuses)"),
}


def _usage() -> str:
    lines = [
        "usage: python -m repro_torch <surface> <verb> [options]",
        "",
        "surfaces:",
    ]
    for name, (_, help_line) in SURFACES.items():
        lines.append(f"  {name:<8} {help_line}")
    lines += [
        "",
        "run `python -m repro_torch <surface> --help` for that surface's verbs.",
    ]
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0 if argv else 2
    surface, rest = argv[0], argv[1:]
    entry = SURFACES.get(surface)
    if entry is None:
        print(f"unknown surface {surface!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    return entry[0](rest, f"repro_torch {surface}")


if __name__ == "__main__":
    sys.exit(main())
