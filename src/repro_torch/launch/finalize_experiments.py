"""Inline the port's generated roofline/perf tables into EXPERIMENTS.md
(the reference's ``launch/finalize_experiments.py``). The port's
placeholders carry a ``TORCH_`` prefix, so the two packages' tables never
overwrite each other.

    python -m repro_torch.launch.finalize_experiments
"""

import os

from .report_md import perf_table, roofline_table

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "../../.."))
PATH = os.path.join(ROOT, "EXPERIMENTS.md")


def main() -> None:
    with open(PATH) as f:
        text = f.read()
    text = text.replace(
        "<!-- TORCH_ROOFLINE_TABLE_16x16 -->", roofline_table("16x16").rstrip()
    )
    text = text.replace(
        "<!-- TORCH_ROOFLINE_TABLE_2x16x16 -->", roofline_table("2x16x16").rstrip()
    )
    text = text.replace("<!-- TORCH_PERF_TABLE -->", perf_table().rstrip())
    with open(PATH, "w") as f:
        f.write(text)
    print("EXPERIMENTS.md tables inlined")


if __name__ == "__main__":
    main()
