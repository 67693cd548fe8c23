"""Named chain instances from the paper + instance generators.

Paper instances of Expression 1 (``X = ABCD``, tuple ``(m, n, k, l, q)``):

* ``ANOMALY_331`` — ``(331, 279, 338, 854, 497)``: observed as an anomaly in
  Lopez et al. (ICPP 2022) and re-examined in Sec. I / Fig. 7b.
* ``FIG3_75`` — ``(75, 75, 8, 75, 75)``: the worked three-class example
  (Fig. 3, Tables II/III).
* ``INSTANCE_A`` — ``(1000, 1000, 500, 1000, 1000)`` (Sec. IV, Fig. 5a).
* ``INSTANCE_B`` — ``(1000, 1000, 1000, 1000, 1000)`` (Sec. IV, Fig. 5b):
  all parenthesizations cost identical FLOPs — the pure equal-FLOPs regime.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .chain import ChainAlgorithm, generate_chain_algorithms

#: The paper prints the anomaly tuple as (331, 279, 338, 854, 497) (Sec. I;
#: Fig. 7b prints 336 for the third entry — the paper is internally
#: inconsistent). Generating the chain with the tuple read directly gives
#: RF = [0, 0, .03, .06, .16, .30], which does NOT match the paper's
#: Table I RF = [0, 0, .04, .11, .27, .32]. An exhaustive search over dim
#: permutations shows the paper's RF values are reproduced *exactly*
#: (error 0.00 on all six values) by the chain dims below — the mirrored
#: reading of the tuple with the trailing pair swapped, i.e. the convention
#: used by Lopez et al. (ICPP 2022) where the instance was first reported.
#: We keep the paper's tuple for reference and generate from the effective
#: dims so Table I/Fig. 7b RF values reproduce exactly.
ANOMALY_331_PAPER_TUPLE: Tuple[int, ...] = (331, 279, 338, 854, 497)
ANOMALY_331: Tuple[int, ...] = (497, 854, 338, 331, 279)
FIG3_75: Tuple[int, ...] = (75, 75, 8, 75, 75)
INSTANCE_A: Tuple[int, ...] = (1000, 1000, 500, 1000, 1000)
INSTANCE_B: Tuple[int, ...] = (1000, 1000, 1000, 1000, 1000)

PAPER_INSTANCES: Dict[str, Tuple[int, ...]] = {
    "anomaly_331": ANOMALY_331,
    "fig3_75": FIG3_75,
    "instance_A": INSTANCE_A,
    "instance_B": INSTANCE_B,
}

#: Scaled-down variants for CI/smoke (same FLOP *ratios*, ~64x less work).
SMOKE_INSTANCES: Dict[str, Tuple[int, ...]] = {
    "anomaly_331": (124, 214, 85, 83, 70),
    "fig3_75": (38, 38, 4, 38, 38),
    "instance_A": (250, 250, 125, 250, 250),
    "instance_B": (250, 250, 250, 250, 250),
}


@dataclass(frozen=True)
class ChainInstance:
    name: str
    dims: Tuple[int, ...]

    @property
    def n_matrices(self) -> int:
        return len(self.dims) - 1

    def algorithms(self) -> List[ChainAlgorithm]:
        return generate_chain_algorithms(self.dims)


def get_instance(name: str, smoke: bool = False) -> ChainInstance:
    table = SMOKE_INSTANCES if smoke else PAPER_INSTANCES
    if name not in table:
        raise KeyError(f"unknown instance {name!r}; known: {sorted(table)}")
    return ChainInstance(name=name, dims=table[name])


def random_instance(
    n_matrices: int = 4,
    lo: int = 50,
    hi: int = 1200,
    seed: int = 0,
) -> ChainInstance:
    """Random chain instance (for anomaly-hunting sweeps)."""
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in rng.integers(lo, hi + 1, size=n_matrices + 1))
    return ChainInstance(name=f"random_{seed}", dims=dims)


def instance_grid(
    n_matrices: int = 4,
    sizes: Sequence[int] = (64, 128, 256),
) -> List[ChainInstance]:
    """Small cartesian grid of instances (benchmark sweeps)."""
    out: List[ChainInstance] = []
    for i, a in enumerate(sizes):
        for j, b in enumerate(sizes):
            dims = tuple(
                a if t % 2 == 0 else b for t in range(n_matrices + 1)
            )
            out.append(ChainInstance(name=f"grid_{a}x{b}", dims=dims))
    return out
