"""The traffic generators: what each cell asks of the program, from the seed.

Frozen copies of the draws that define an instance, so that a later change
to the program cannot change the work:

- a chain's dimensions, drawn as the census draws instance ``i``
  (``numpy.random.default_rng(i).integers(lo, hi + 1, n + 1)``), and the
  census's matrices of instance ``i`` (a CPU ``torch.Generator`` seeded with
  ``i``, each matrix scaled by 1/sqrt(columns));
- the benchmark's own chain matrices, made on the device from a seed;
- the SSD inputs in the ``ssd_chunk`` site's layout.

Every seed is given the same set of sizes in another order (:func:`rounds`),
so runs on different seeds do the same work and differ in order and values.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch


def derive(seed: int, *path: int) -> int:
    """A seed below 2**63 for the stream ``path`` of run seed ``seed`` (any
    whole number; negative ones are taken modulo 2**64)."""
    words = [int(seed) % 2**64, *path]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def rounds(seed: int, stream: int, pool: int) -> Iterator[int]:
    """Indices into a pool of ``pool`` units, round after round, each round
    every unit once in an order drawn from ``seed``."""
    rng = np.random.default_rng(derive(seed, stream))
    while True:
        yield from (int(i) for i in rng.permutation(pool))


def chain_dims(n_matrices: int, lo: int, hi: int, seed: int) -> Tuple[int, ...]:
    """Dimensions of chain instance ``seed``, uniform in [lo, hi]."""
    rng = np.random.default_rng(seed)
    return tuple(int(d) for d in rng.integers(lo, hi + 1, size=n_matrices + 1))


def census_inputs(dims: Sequence[int], seed: int) -> List[torch.Tensor]:
    """The census's f32 matrices of instance ``seed``, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((dims[i], dims[i + 1]), generator=gen) / math.sqrt(dims[i + 1])
            for i in range(len(dims) - 1)]


def chain_inputs(dims: Sequence[int], seed: int, device: torch.device) -> List[torch.Tensor]:
    """f32 matrices for ``dims`` made on ``device`` from ``seed``, each
    scaled by 1/sqrt(columns)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((dims[i], dims[i + 1]), generator=gen, device=device)
            / math.sqrt(dims[i + 1]) for i in range(len(dims) - 1)]


def ssd_inputs(b: int, s: int, h: int, p: int, n: int, seed: int,
               device: torch.device) -> List[torch.Tensor]:
    """x [b,s,h,p], dt [b,s,h] (softplus of a normal draw), a_log [h],
    B and C [b,s,1,n] in f32, made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen, device=device)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=device))
    a_log = torch.randn((h,), generator=gen, device=device) * 0.5
    bm = torch.randn((b, s, 1, n), generator=gen, device=device)
    cm = torch.randn((b, s, 1, n), generator=gen, device=device)
    return [x, dt, a_log, bm, cm]
