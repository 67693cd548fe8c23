"""Algorithm -> kernel-sequence decomposition (the explainer's substrate).

Every census algorithm is a short straight-line program of linear-algebra
kernels: a chain parenthesization is a sequence of GEMMs whose shapes follow
from the dims, and each beyond-chain family variant decomposes by its
defining identity (``solve_lu`` = LU factorization + two triangular solves,
``gram_left_syrk`` = SYRK + GEMM, ...). The decomposition is *exact* in the
analytic FLOP accounting — per algorithm, kernel FLOPs sum to the family's
``flops_table`` entry — which is what lets the AnomalyExplainer reconcile
whole-algorithm time against the kernel sum without a fudge term.

Pure python/numpy, as the reference's ``repro.explain.decompose``;
:func:`build_kernel_workload` touches a device only when a wall-clock
explanation re-measures a kernel in isolation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

#: Bytes per element for the kernels' working precision (census workloads
#: are float32 throughout).
_ELEM_BYTES = 4

#: op -> (flops, moved bytes) as functions of the shape tuple. FLOPs follow
#: the paper's accounting (2mkn GEMM, syrk = half of the AAt GEMM, LAPACK
#: leading terms for the factorizations); bytes are the operands + result
#: touched once — the roofline floor for an isolated, cache-cold kernel.
_OPS: Dict[str, Tuple[Callable[..., float], Callable[..., float]]] = {
    # (m, k, n): C[m,n] = A[m,k] @ B[k,n]
    "gemm": (lambda m, k, n: 2.0 * m * k * n,
             lambda m, k, n: float(_ELEM_BYTES) * (m * k + k * n + m * n)),
    # (n, k): C[n,n] = A[n,k] @ A[n,k]^T, symmetric half-FLOPs accounting
    "syrk": (lambda n, k: 1.0 * n * n * k,
             lambda n, k: float(_ELEM_BYTES) * (n * k + n * n)),
    # (m, n): y[m] = A[m,n] @ x[n]
    "gemv": (lambda m, n: 2.0 * m * n,
             lambda m, n: float(_ELEM_BYTES) * (m * n + n + m)),
    # (n,): u . v
    "dot": (lambda n: 2.0 * n,
            lambda n: float(_ELEM_BYTES) * (2 * n + 1)),
    # (m, n): C = A + B, elementwise
    "add": (lambda m, n: 1.0 * m * n,
            lambda m, n: float(_ELEM_BYTES) * 3 * m * n),
    # (n,): explicit inverse of a dense n x n matrix (getrf + getri)
    "inv": (lambda n: 2.0 * n**3,
            lambda n: float(_ELEM_BYTES) * 2 * n * n),
    # (n,): LU factorization, leading term
    "getrf": (lambda n: (2.0 / 3.0) * n**3,
              lambda n: float(_ELEM_BYTES) * 2 * n * n),
    # (n,): Cholesky factorization, leading term
    "potrf": (lambda n: (1.0 / 3.0) * n**3,
              lambda n: float(_ELEM_BYTES) * 2 * n * n),
    # (n,): one triangular solve with a vector RHS
    "trsv": (lambda n: 1.0 * n * n,
             lambda n: float(_ELEM_BYTES) * (n * n + 2 * n)),
}

#: op -> result elements (the intermediate a following kernel may reuse).
_OUT_ELEMS: Dict[str, Callable[..., float]] = {
    "gemm": lambda m, k, n: float(m * n),
    "syrk": lambda n, k: float(n * n),
    "gemv": lambda m, n: float(m),
    "dot": lambda n: 1.0,
    "add": lambda m, n: float(m * n),
    "inv": lambda n: float(n * n),
    "getrf": lambda n: float(n * n),
    "potrf": lambda n: float(n * n),
    "trsv": lambda n: float(n),
}


@dataclass(frozen=True)
class KernelSpec:
    """One kernel call: an op name plus its shape parameters."""

    op: str
    shape: Tuple[int, ...]

    def __post_init__(self) -> None:
        if self.op not in _OPS:
            raise ValueError(f"unknown kernel op {self.op!r}; one of {sorted(_OPS)}")

    @property
    def flops(self) -> float:
        return _OPS[self.op][0](*self.shape)

    @property
    def bytes(self) -> float:
        return _OPS[self.op][1](*self.shape)

    @property
    def out_bytes(self) -> float:
        """Bytes of the kernel's result — the working set a directly
        following kernel can pick up from cache instead of memory (the
        cache-reuse pair scoring of the explainer's attribution)."""
        return float(_ELEM_BYTES) * _OUT_ELEMS[self.op](*self.shape)

    @property
    def label(self) -> str:
        return f"{self.op}[{','.join(str(d) for d in self.shape)}]"

    def to_compact(self) -> List[Any]:
        """``[op, [dims...]]`` — the census-record pointer format."""
        return [self.op, list(self.shape)]

    @classmethod
    def from_compact(cls, c: Sequence[Any]) -> "KernelSpec":
        return cls(op=str(c[0]), shape=tuple(int(d) for d in c[1]))


def kernel_name(alg: str, index: int, kernel: KernelSpec) -> str:
    """Measurement-session name of one kernel segment, unique per algorithm
    (``algorithm3::01.gemm``)."""
    return f"{alg}::{index:02d}.{kernel.op}"


# ----------------------------------------------------------- decomposition ---


def decompose_chain(dims: Sequence[int], steps: Sequence[Tuple[str, str, str]]) -> List[KernelSpec]:
    """Kernels of one chain algorithm: a GEMM per instruction, shapes
    propagated through the temp environment (``M#`` leaves, ``T#`` temps)."""
    env: Dict[str, Tuple[int, int]] = {
        f"M{i}": (int(dims[i]), int(dims[i + 1])) for i in range(len(dims) - 1)
    }
    out: List[KernelSpec] = []
    for dest, lhs, rhs in steps:
        (m, k), (k2, n) = env[lhs], env[rhs]
        if k != k2:
            raise ValueError(f"shape mismatch at {dest}: {env[lhs]} @ {env[rhs]}")
        out.append(KernelSpec("gemm", (m, k, n)))
        env[dest] = (m, n)
    return out


def decompose_generalized(family: str, size: int) -> Dict[str, List[KernelSpec]]:
    """Kernel sequences of every variant of one beyond-chain family at
    ``size`` — mirrors :mod:`repro_torch.expressions.generalized` identity by
    identity (and is FLOP-exact against its ``flops_table``). Memoized per
    (family, size); callers get fresh list containers over the shared
    frozen :class:`KernelSpec` values."""
    return {
        alg: list(ks)
        for alg, ks in _decompose_generalized_cached(family, int(size)).items()
    }


@lru_cache(maxsize=4096)
def _decompose_generalized_cached(
    family: str, size: int
) -> Dict[str, List[KernelSpec]]:
    n = int(size)
    if family == "gram":
        k = max(1, n // 4)  # repro_torch.expressions.generalized.FAMILIES convention
        return {
            "gram_left": [KernelSpec("gemm", (n, k, n)), KernelSpec("gemm", (n, n, n))],
            "gram_right": [KernelSpec("gemm", (k, n, n)), KernelSpec("gemm", (n, k, n))],
            "gram_left_syrk": [KernelSpec("syrk", (n, k)), KernelSpec("gemm", (n, n, n))],
        }
    if family == "distributive":
        return {
            "dist_factored": [KernelSpec("add", (n, n)), KernelSpec("gemm", (n, n, n))],
            "dist_expanded": [
                KernelSpec("gemm", (n, n, n)),
                KernelSpec("gemm", (n, n, n)),
                KernelSpec("add", (n, n)),
            ],
        }
    if family == "solve":
        return {
            "solve_inverse": [KernelSpec("inv", (n,)), KernelSpec("gemv", (n, n))],
            "solve_lu": [
                KernelSpec("getrf", (n,)),
                KernelSpec("trsv", (n,)),
                KernelSpec("trsv", (n,)),
            ],
            "solve_chol": [
                KernelSpec("potrf", (n,)),
                KernelSpec("trsv", (n,)),
                KernelSpec("trsv", (n,)),
            ],
        }
    if family == "bilinear":
        return {
            "bilinear_left": [KernelSpec("gemv", (n, n)), KernelSpec("dot", (n,))],
            "bilinear_right": [KernelSpec("gemv", (n, n)), KernelSpec("dot", (n,))],
        }
    raise ValueError(f"unknown family {family!r}")


def decompose_chain_dims(dims: Sequence[int]) -> Dict[str, List[KernelSpec]]:
    """Kernels of EVERY algorithm of a chain instance (lazy import: the
    enumeration layer is pure python). Memoized per dims tuple — an
    explanation touches the same instance's decomposition several times
    (session build, timer rebuild, ground-truth reconstruction), and
    enumerating a chain's full parenthesization set is the expensive
    part."""
    return {
        alg: list(ks)
        for alg, ks in _decompose_chain_dims_cached(
            tuple(int(d) for d in dims)
        ).items()
    }


@lru_cache(maxsize=1024)
def _decompose_chain_dims_cached(
    dims: Tuple[int, ...]
) -> Dict[str, List[KernelSpec]]:
    from repro_torch.expressions.chain import generate_chain_algorithms

    return {
        alg.name: decompose_chain(dims, alg.steps)
        for alg in generate_chain_algorithms(list(dims))
    }


def decompose_instance(family: str, params: Mapping[str, Any]) -> Dict[str, List[KernelSpec]]:
    """Kernels per algorithm for one census instance, rebuilt purely from
    its (family, params) row — no device, no re-measurement. Resolved through
    the :mod:`repro_torch.core.family` registry (families memoize their own
    expensive enumerations)."""
    from repro_torch.core.family import get_family

    return get_family(family).decompose(params)


@lru_cache(maxsize=4096)
def _chain_instance_dims(
    n_matrices: int, lo: int, hi: int, seed: int
) -> Tuple[int, ...]:
    """The dims a chain instance row expands to (the instance generator is
    a pure function of its arguments, so the mapping is cacheable)."""
    from repro_torch.expressions.instances import random_instance

    return tuple(int(d) for d in random_instance(n_matrices, lo, hi, seed=seed).dims)


def kernels_to_compact(kernels_by_alg: Mapping[str, Sequence[KernelSpec]]) -> Dict[str, List[List[Any]]]:
    return {alg: [k.to_compact() for k in ks] for alg, ks in kernels_by_alg.items()}


def kernels_from_compact(compact: Mapping[str, Sequence[Sequence[Any]]]) -> Dict[str, List[KernelSpec]]:
    return {alg: [KernelSpec.from_compact(c) for c in ks] for alg, ks in compact.items()}


def kernels_from_record(record: Mapping[str, Any]) -> Dict[str, List[KernelSpec]]:
    """Kernel specs for a census record: read the ``kernels`` pointer when
    the census wrote one, else rebuild from the ``params`` pointer, else
    (pre-pointer censuses) fall back to the family/dims fields."""
    if record.get("kernels"):
        return kernels_from_compact(record["kernels"])
    if record.get("params"):
        return decompose_instance(record["family"], record["params"])
    if record["family"] == "chain" and record.get("dims"):
        return decompose_chain_dims(record["dims"])
    return decompose_generalized(record["family"], int(record["size"]))


# ------------------------------------------------------- isolated workloads ---


def _segment_ops() -> Dict[str, Callable[..., Any]]:
    """op -> the PyTorch call that runs it, the call the families use for
    the same op (:mod:`repro_torch.expressions.generalized`), so that a
    segment and its algorithm are measured alike: ``torch.matmul`` (cuBLAS
    on the card) for the products, ``torch.linalg`` (cuSOLVER) for the
    factorizations and solves. getrf returns the packed LU factor of
    ``torch.linalg.lu_factor``; the reference returns the unit-lower L of
    ``jax.scipy.linalg.lu``, the same factorization."""
    import torch

    return {
        "gemm": lambda a, b: a @ b,
        "syrk": lambda a: a @ a.T,
        "gemv": lambda a, x: a @ x,
        "dot": lambda u, v: u @ v,
        "add": lambda a, b: a + b,
        "inv": torch.linalg.inv,
        "getrf": lambda m: torch.linalg.lu_factor(m)[0],
        "potrf": torch.linalg.cholesky,
        "trsv": lambda l, b: torch.linalg.solve_triangular(l, b[:, None], upper=False)[:, 0],
    }


def _segment(op: str, args: Sequence[Any]) -> Callable[[], Any]:
    """A zero-arg callable running ``op`` once on ``args`` and waiting for
    it (one eager launch plus :func:`~repro_torch.device.block`), warmed up
    here so that library set-up stays out of the timed region."""
    from repro_torch.device import block

    fn = _segment_ops()[op]
    block(fn(*args))

    def run() -> Any:
        return block(fn(*args))

    return run


def build_kernel_workload(kernel: KernelSpec, seed: int = 0,
                          device: Any = "cuda") -> Callable[[], Any]:
    """A zero-arg callable executing ONE kernel in isolation on fresh
    random operands on ``device`` (blocking, warmed up) — the wall-clock
    backend's segment re-measurement.

    Operands come from a ``torch.Generator`` on the device seeded with
    ``seed``, with the reference's scalings (``1/sqrt(cols)``) and its SPD
    shift (``a aᵀ + n I``) for the factorizations; their numbers differ from
    ``jax.random``'s, so to hold a segment to the reference's on the same
    bytes use :func:`build_kernel_workload_from_reference`."""
    import math

    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def normal(shape: Tuple[int, ...]) -> Any:
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) / math.sqrt(max(shape[-1], 1))

    op, shape = kernel.op, kernel.shape
    if op == "gemm":
        m, k, n = shape
        args = [normal((m, k)), normal((k, n))]
    elif op == "syrk":
        n, k = shape
        args = [normal((n, k))]
    elif op == "gemv":
        m, n = shape
        args = [normal((m, n)), normal((n,))]
    elif op == "dot":
        (n,) = shape
        args = [normal((n,)), normal((n,))]
    elif op == "add":
        m, n = shape
        args = [normal((m, n)), normal((m, n))]
    elif op in ("inv", "getrf", "potrf", "trsv"):
        (n,) = shape
        a = normal((n, n))
        spd = a @ a.T + n * torch.eye(n, dtype=torch.float32, device=dev)  # well-conditioned
        if op == "trsv":
            args = [torch.linalg.cholesky(spd), normal((n,))]
        else:
            args = [spd]
    else:  # pragma: no cover - _OPS and this table are kept in sync
        raise ValueError(f"no workload builder for op {op!r}")
    return _segment(op, args)


def build_kernel_workload_from_reference(
    kernel: KernelSpec, arrays: Sequence[Any], device: Any = "cuda"
) -> Callable[[], Any]:
    """:func:`build_kernel_workload` on the given operands (numpy arrays in
    the order the reference's workload takes them, e.g. its own inputs bit
    for bit) instead of drawn ones."""
    from repro_torch.expressions.algorithms import inputs_from_reference

    return _segment(kernel.op, inputs_from_reference(arrays, device=device))
