"""AlgorithmFamily — the census's one algorithm-source seam.

The paper's methodology ranks *any* set of FLOP-equivalent algorithms; the
census should therefore not hard-code where algorithms come from. This
module is the single registry every layer resolves through:

* :class:`SweepSpec` validation and grid expansion (:mod:`repro_torch.core.sweep`)
* the planner's CLI grid flags (:mod:`repro_torch.launch.sweep`)
* the explainer's kernel decomposition (:mod:`repro_torch.explain.decompose`)
  and whole-algorithm re-measurement (:mod:`repro_torch.explain.runner`)
* the markdown reports' family annotations (:mod:`repro_torch.launch.report_md`)

An :class:`AlgorithmFamily` supplies, for one family name:

``expand_grid``
    deterministic grid expansion into :class:`InstanceSpec` rows (stable
    uids; global indices are assigned by the sweep after concatenation).
``entry``
    the instance's analytic FLOP table, descriptive meta (size, dims, and
    the per-algorithm kernel decomposition — the explainer's rebuild
    pointer), and a lazy workload builder that takes the device the
    workloads run on. Everything except the builder is computed without
    touching a device: the deterministic cost-model hooks
    (:func:`repro_torch.core.sweep.synthetic_instance_model`) consume only
    the FLOP table and kernel counts, so cost-model census workers never
    allocate a single tensor.
``prefetch``
    host work the builds of a census chunk's instances will wait for,
    started before the first is built (the chain family's matrix draws;
    nothing elsewhere).
``decompose``
    kernels per algorithm purely from the instance's ``params`` row — the
    explainer's offline rebuild path (no device, no re-measurement).
``explain_workloads``
    warmed whole-algorithm workloads on a device for only the algorithms an
    explanation involves (families with large enumerations override this
    to build selectively).
``grid_from_args``
    the family's slice of the planner's CLI namespace (None = the family
    is not part of this plan).

Five synthetic families (the paper's chain plus the beyond-chain identity
families) are registered here bit-identically to their pre-registry
implementations, alongside ``kernel_variants`` — the first *measured*
family, whose algorithms are kernel variants (the hand GEMM's tile shapes,
fused vs unfused attention, SSD chunk lengths) of the same math, wrapping
the autotuner's :class:`~repro_torch.autotune.variants.VariantSite` objects.

A copy of the reference's ``repro.core.family``: names, uids, params, FLOP
tables and kernel decompositions are the reference's byte for byte, so the
deterministic census stores of both packages are identical. The workload
builders run on ``torch`` on an explicit device (default ``"cuda"``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device

#: A workload builder: device -> {algorithm name: zero-arg timed thunk}.
Builder = Callable[[DeviceLike], Dict[str, Callable[[], Any]]]
#: (flops table, descriptive meta, workload builder) — the shape
#: `instance_entry` has always returned.
Entry = Tuple[Dict[str, float], Dict[str, Any], Builder]


@dataclass(frozen=True)
class InstanceSpec:
    """One census row: an expression instance, fully determined by JSON."""

    index: int                #: position in the expanded grid (global order)
    uid: str                  #: stable identifier, unique within the sweep
    family: str               #: a registered family name
    params: Dict[str, Any]    #: family-specific (dims / size / seed)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "index": self.index, "uid": self.uid,
            "family": self.family, "params": dict(self.params),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "InstanceSpec":
        return cls(
            index=int(d["index"]), uid=str(d["uid"]),
            family=str(d["family"]), params=dict(d["params"]),
        )


class AlgorithmFamily:
    """Base class: one source of FLOP-comparable algorithm sets."""

    #: registry key; also the ``family`` field of every record it produces
    name: str = ""
    #: one-line description (report footnotes, CLI help)
    description: str = ""

    # ------------------------------------------------------------- grid ---

    def expand_grid(self, grid: Mapping[str, Any]) -> List[InstanceSpec]:
        """Deterministic expansion of this family's grid dict into
        InstanceSpec rows with ``index=0`` placeholders (the sweep assigns
        global indices after concatenating all families)."""
        raise NotImplementedError

    def grid_from_args(self, args: Any) -> Optional[Dict[str, Any]]:
        """This family's grid dict from the planner's argparse namespace,
        or None when the arguments exclude the family from the plan."""
        return None

    # --------------------------------------------------------- instances ---

    def entry(self, inst: InstanceSpec) -> Entry:
        """(flops table, meta, workload-builder). ``meta`` must carry
        ``size`` (scalar for the census's size buckets), ``dims`` (or
        None) and ``kernels`` (compact per-algorithm decomposition). Only
        calling the returned builder (with a device) touches a device."""
        raise NotImplementedError

    def prefetch(self, insts: Sequence[InstanceSpec]) -> None:
        """Start, on the host, what the builds of ``insts`` (in the order
        they will be built) will wait for. Default: nothing."""

    def decompose(self, params: Mapping[str, Any]) -> Dict[str, Any]:
        """KernelSpecs per algorithm, purely from the params row."""
        raise NotImplementedError

    def explain_workloads(
        self, inst: InstanceSpec, involved: Sequence[str], device: DeviceLike = "cuda"
    ) -> Dict[str, Callable[[], Any]]:
        """Warmed workloads on ``device`` for ONLY the involved algorithms.
        Default: build the full instance and filter — fine for families
        with a handful of variants; families that enumerate dozens of
        algorithms override this to build selectively."""
        _, _, build_workloads = self.entry(inst)
        whole = build_workloads(device)
        return {alg: whole[alg] for alg in involved}


# --------------------------------------------------------------- registry ---


_REGISTRY: Dict[str, AlgorithmFamily] = {}


def register_family(family: AlgorithmFamily) -> AlgorithmFamily:
    """Register (or replace) a family under its ``name``."""
    if not family.name:
        raise ValueError("family must define a non-empty name")
    _REGISTRY[family.name] = family
    return family


def get_family(name: str) -> AlgorithmFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown algorithm family {name!r}; one of {family_names()}"
        ) from None


def family_names() -> Tuple[str, ...]:
    """Registered family names, in registration order."""
    return tuple(_REGISTRY)


# ---------------------------------------------------------- chain family ---


class ChainFamily(AlgorithmFamily):
    """The paper's Expression 1: matrix-chain parenthesizations x
    instruction orders (:mod:`repro_torch.expressions.instances`)."""

    name = "chain"
    description = (
        "matrix-chain parenthesizations x instruction orders "
        "(the paper's Expression 1), random dims per instance"
    )

    def expand_grid(self, grid: Mapping[str, Any]) -> List[InstanceSpec]:
        count = int(grid.get("count", 0))
        n_list = [int(n) for n in grid.get("n_matrices", [4])]
        lo, hi = int(grid.get("lo", 32)), int(grid.get("hi", 512))
        out: List[InstanceSpec] = []
        for i in range(count):
            n = n_list[i % len(n_list)]
            out.append(InstanceSpec(
                index=0,
                uid=f"chain-n{n}-i{i:05d}",
                family="chain",
                params={"n_matrices": n, "lo": lo, "hi": hi, "seed": i},
            ))
        return out

    def grid_from_args(self, args: Any) -> Optional[Dict[str, Any]]:
        if int(getattr(args, "chains", 0)) <= 0:
            return None
        return {
            "count": args.chains, "n_matrices": args.chain_sizes,
            "lo": args.lo, "hi": args.hi,
        }

    def entry(self, inst: InstanceSpec) -> Entry:
        """Expression generators are imported lazily so cost-model workers
        never build a single tensor. ``meta["kernels"]`` carries the
        per-algorithm kernel decomposition (computed here, where the
        enumerated algorithms already exist) — the AnomalyExplainer's
        rebuild pointer."""
        from repro_torch.explain.decompose import decompose_chain, kernels_to_compact
        from repro_torch.expressions.chain import flops_table

        p = inst.params
        chain = self._chain(inst)
        algs = chain.algorithms()
        flops = flops_table(algs)
        dims = list(chain.dims)
        size = int(round(float(np.exp(np.mean(np.log(dims))))))  # geometric mean
        kernels = kernels_to_compact(
            {a.name: decompose_chain(dims, a.steps) for a in algs}
        )

        def build_workloads(device: DeviceLike) -> Dict[str, Callable[[], Any]]:
            from repro_torch.expressions.algorithms import build_workloads as bw
            from repro_torch.expressions.algorithms import make_chain_inputs

            mats = make_chain_inputs(chain.dims, seed=int(p["seed"]), device=device)
            return bw(algs, mats, warmup=True)

        meta = {"size": size, "dims": dims, "kernels": kernels}
        return flops, meta, build_workloads

    def prefetch(self, insts: Sequence[InstanceSpec]) -> None:
        """The instances' matrices drawn ahead on host threads, where the
        census's builds run inside
        :func:`~repro_torch.expressions.algorithms.drawing_ahead` on a
        CUDA device; their builds take them with the same bytes."""
        from repro_torch.expressions.algorithms import plan_chain_inputs

        plan_chain_inputs([(self._chain(i).dims, int(i.params["seed"])) for i in insts])

    @staticmethod
    def _chain(inst: InstanceSpec):
        """The instance's :class:`~repro_torch.expressions.instances.ChainInstance`."""
        from repro_torch.expressions.instances import random_instance

        p = inst.params
        return random_instance(
            int(p["n_matrices"]), int(p["lo"]), int(p["hi"]), seed=int(p["seed"])
        )

    def decompose(self, params: Mapping[str, Any]) -> Dict[str, Any]:
        from repro_torch.explain.decompose import _chain_instance_dims, decompose_chain_dims

        dims = _chain_instance_dims(
            int(params["n_matrices"]), int(params["lo"]), int(params["hi"]),
            int(params["seed"]),
        )
        return decompose_chain_dims(dims)

    def explain_workloads(
        self, inst: InstanceSpec, involved: Sequence[str], device: DeviceLike = "cuda"
    ) -> Dict[str, Callable[[], Any]]:
        """A chain instance enumerates dozens of algorithms; building all
        of them to extract a winner/loser pair would dominate every
        wall-clock explanation, so chains build the involved thunks
        selectively (``jit=True``: one CUDA graph each on the card)."""
        from repro_torch.expressions.algorithms import build_algorithm_fn, make_chain_inputs

        p = inst.params
        chain = self._chain(inst)
        algs = {a.name: a for a in chain.algorithms()}
        mats = make_chain_inputs(chain.dims, seed=int(p["seed"]), device=device)
        out: Dict[str, Callable[[], Any]] = {}
        for alg in involved:
            fn = build_algorithm_fn(algs[alg], mats, jit=True)
            fn()  # warm up: capture and library set-up stay out of timed regions
            out[alg] = fn
        return out


# ---------------------------------------------------- generalized families ---


class GeneralizedFamily(AlgorithmFamily):
    """A beyond-chain identity family from
    :mod:`repro_torch.expressions.generalized` (gram / distributive / solve /
    bilinear): ``per_size`` seeded instances at each grid size."""

    def __init__(self, name: str, description: str) -> None:
        self.name = name
        self.description = description

    def expand_grid(self, grid: Mapping[str, Any]) -> List[InstanceSpec]:
        sizes = [int(s) for s in grid.get("sizes", ())]
        per_size = int(grid.get("per_size", 1))
        out: List[InstanceSpec] = []
        for size in sizes:
            for s in range(per_size):
                out.append(InstanceSpec(
                    index=0,
                    uid=f"{self.name}-n{size}-s{s:03d}",
                    family=self.name,
                    params={"size": size, "seed": s},
                ))
        return out

    def grid_from_args(self, args: Any) -> Optional[Dict[str, Any]]:
        return {"sizes": args.sizes, "per_size": args.per_size}

    def entry(self, inst: InstanceSpec) -> Entry:
        from repro_torch.explain.decompose import decompose_generalized, kernels_to_compact
        from repro_torch.expressions.generalized import FAMILIES as GEN

        p = inst.params
        size = int(p["size"])
        family = GEN[inst.family](n=size)
        flops = family.flops_table()
        kernels = kernels_to_compact(decompose_generalized(inst.family, size))

        def build_workloads(device: DeviceLike) -> Dict[str, Callable[[], Any]]:
            return family.workloads(size, seed=int(p["seed"]), warmup=True, device=device)

        meta = {"size": size, "dims": None, "kernels": kernels}
        return flops, meta, build_workloads

    def decompose(self, params: Mapping[str, Any]) -> Dict[str, Any]:
        from repro_torch.explain.decompose import decompose_generalized

        return decompose_generalized(self.name, int(params["size"]))


# ------------------------------------------------- kernel_variants family ---

#: sites the family can census, in CLI order
KERNEL_SITES = ("matmul", "attention", "ssd")


def _kernel_site_config(site: str, size: int) -> Dict[str, Any]:
    """Pure (no-device) per-site metadata at one grid size: algorithm names,
    the shared-math kernel decomposition, and the VariantSite constructor
    arguments. The decomposition describes the *shared math* once — every
    variant computes the same function, so every variant carries the same
    kernel list and the same analytic FLOP count (FLOP-identical by
    construction; implementation overhead — masked blocks, chunk-quadratic
    terms, tile padding — is exactly what the census measures).
    """
    from repro_torch.explain.decompose import KernelSpec

    size = int(size)
    if site == "matmul":
        # GEMM tile shapes (+ the library baseline, named ``xla_dot`` as in
        # the reference's records): 2mkn exactly, for every tiling. Below
        # size 16 the tile (size,)*3 keeps the metadata the reference's;
        # the hand GEMM has no such tile, so building it raises
        m = k = n = size
        blocks = [(b, b, b) for b in (16, 32, 64) if b <= size] or [(size,) * 3]
        names = [f"blocks_{bm}x{bn}x{bk}" for bm, bn, bk in blocks] + ["xla_dot"]
        return {
            "names": names,
            "kernels": [KernelSpec("gemm", (m, k, n))],
            "site_kwargs": {"m": m, "k": k, "n": n, "blocks": blocks},
        }
    if site == "attention":
        # fused (chunked flash-style) vs unfused reference blocks: the
        # shared math is the scores GEMM + the output GEMM, batch*heads
        # folded into the row dimension
        b, h, kv, d = 1, 2, 1, 16
        s = size
        names = ["reference_grouped", "reference_broadcast", "chunked_flash"]
        return {
            "names": names,
            "kernels": [
                KernelSpec("gemm", (b * h * s, d, s)),   # scores  Q @ K^T
                KernelSpec("gemm", (b * h * s, s, d)),   # output  P @ V
            ],
            "site_kwargs": {"b": b, "s": s, "h": h, "kv": kv, "d": d},
        }
    if site == "ssd":
        # Mamba-2 SSD chunk lengths: the shared math at the reference
        # chunk q0 — intra-chunk scores (C @ B^T), their application to x,
        # and the two state GEMMs (build B^T x, apply C) — aggregated over
        # batch*heads*tokens
        b, h, p, n = 1, 2, 8, 8
        s = size
        chunks = [c for c in (8, 16, 32, 64) if c <= s and s % c == 0]
        if len(chunks) < 2:
            raise ValueError(
                f"kernel_variants ssd site needs >= 2 chunk lengths dividing "
                f"size {s} (have {chunks}); use a size that is a multiple of 16"
            )
        q0 = chunks[0]
        return {
            "names": [f"chunk_{q}" for q in chunks],
            "kernels": [
                KernelSpec("gemm", (b * h * s, n, q0)),  # scores   C @ B^T
                KernelSpec("gemm", (b * h * s, q0, p)),  # apply    G @ X
                KernelSpec("gemm", (b * h * s, n, p)),   # state    B^T @ X
                KernelSpec("gemm", (b * h * s, p, n)),   # output   S @ C
            ],
            "site_kwargs": {"b": b, "s": s, "h": h, "p": p, "n": n,
                            "chunks": chunks},
        }
    raise ValueError(f"unknown kernel site {site!r}; one of {KERNEL_SITES}")


class KernelVariantsFamily(AlgorithmFamily):
    """The repo's own kernels as a census family: every algorithm is a
    kernel variant of the same math (the hand GEMM's tile shapes, fused vs
    unfused attention blocks, SSD chunk lengths), wrapping the autotuner's
    :mod:`~repro_torch.autotune.variants` sites. All variants of an
    instance share one analytic FLOP count and one kernel decomposition
    (the shared math), so the whole instance sits in ``S_F`` and **every**
    rank difference is an anomaly the explainer must attribute. Metadata
    needs no device; only building workloads does — measured through the
    ``wall_clock`` backend, while the deterministic backends exercise the
    same grid through the synthetic cost hooks.

    The instance params keep the reference's ``interpret`` flag (its
    Pallas interpret mode). The card has no counterpart: an
    ``interpret=True`` instance builds on the CPU, where every wrapper
    takes its plain version, and refuses a CUDA device (plan with
    ``--kernel-native`` to time the hand kernels there)."""

    name = "kernel_variants"
    description = (
        "the repo's own kernel variants (hand GEMM tiles, fused vs "
        "unfused attention, SSD chunk lengths) — FLOP-identical by "
        "construction, censused on wall clock"
    )

    def expand_grid(self, grid: Mapping[str, Any]) -> List[InstanceSpec]:
        sites = [str(x) for x in grid.get("sites", KERNEL_SITES)]
        sizes = [int(s) for s in grid.get("sizes", ())]
        per_size = int(grid.get("per_size", 1))
        interpret = bool(grid.get("interpret", True))
        out: List[InstanceSpec] = []
        for site in sites:
            if site not in KERNEL_SITES:
                raise ValueError(
                    f"unknown kernel site {site!r}; one of {KERNEL_SITES}"
                )
            for size in sizes:
                _kernel_site_config(site, size)  # validate shape constraints
                for s in range(per_size):
                    out.append(InstanceSpec(
                        index=0,
                        uid=f"kernel_variants-{site}-n{size}-s{s:03d}",
                        family=self.name,
                        params={"site": site, "size": size, "seed": s,
                                "interpret": interpret},
                    ))
        return out

    def grid_from_args(self, args: Any) -> Optional[Dict[str, Any]]:
        sites = [s for s in getattr(args, "kernel_sites", "").split(",") if s]
        return {
            "sites": sites or list(KERNEL_SITES),
            "sizes": args.sizes,
            "per_size": args.per_size,
            "interpret": not bool(getattr(args, "kernel_native", False)),
        }

    def entry(self, inst: InstanceSpec) -> Entry:
        from repro_torch.explain.decompose import kernels_to_compact

        p = inst.params
        site, size = str(p["site"]), int(p["size"])
        cfg = _kernel_site_config(site, size)
        shared = sum(k.flops for k in cfg["kernels"])
        flops = {name: shared for name in cfg["names"]}
        kernels = kernels_to_compact(
            {name: list(cfg["kernels"]) for name in cfg["names"]}
        )

        def build_workloads(device: DeviceLike) -> Dict[str, Callable[[], Any]]:
            variant_site = self._build_site(
                site, cfg, bool(p.get("interpret", True)), device, uid=inst.uid)
            return variant_site.workloads(seed=int(p["seed"]), warmup=True)

        meta = {"size": size, "dims": None, "kernels": kernels}
        return flops, meta, build_workloads

    @staticmethod
    def _build_site(site: str, cfg: Mapping[str, Any], interpret: bool,
                    device: DeviceLike = "cuda", uid: str = ""):
        """The wrapped VariantSite on ``device`` (built at workload time
        only).

        The matmul site's library baseline is ``torch_matmul`` in the
        autotuner; the census keeps the reference's algorithm name
        ``xla_dot`` for it (record bytes depend on the name), so the site's
        ``torch_matmul`` variant is renamed here and nowhere else."""
        import dataclasses

        dev = resolve_device(device)
        what = uid or f"kernel_variants {site}"
        if interpret and dev.type == "cuda":
            raise ValueError(
                f"{what}: planned with interpret=True (the reference's Pallas "
                "interpret mode), which has no counterpart on a CUDA device; "
                "plan the census with --kernel-native to time the hand "
                "kernels on the card, or build it on device='cpu' for the "
                "plain versions"
            )
        kw = cfg["site_kwargs"]
        if site == "matmul":
            from repro_torch.autotune.variants import VariantSite, matmul_blocks_site

            try:
                built = matmul_blocks_site(device=dev, **kw)
            except ValueError as err:
                raise ValueError(
                    f"{what}: {err}; a wall-clock kernel_variants matmul "
                    "needs a size of 16 or more (the cost_model and "
                    "simulated backends take any size)"
                ) from err
            return VariantSite(
                name=built.name,
                variants=tuple(
                    dataclasses.replace(v, name="xla_dot") if v.name == "torch_matmul" else v
                    for v in built.variants
                ),
                make_inputs=built.make_inputs,
            )
        if site == "attention":
            from repro_torch.autotune.variants import attention_site

            return attention_site(device=dev, **kw)
        from repro_torch.autotune.variants import ssd_chunk_site

        return ssd_chunk_site(device=dev, **kw)

    def decompose(self, params: Mapping[str, Any]) -> Dict[str, Any]:
        cfg = _kernel_site_config(str(params["site"]), int(params["size"]))
        return {name: list(cfg["kernels"]) for name in cfg["names"]}


# ------------------------------------------------------- the default seam ---

register_family(ChainFamily())
register_family(GeneralizedFamily(
    "gram", "A^T A B — gram product, left/right/syrk associations"))
register_family(GeneralizedFamily(
    "distributive", "(A + B) C — factored vs expanded distribution"))
register_family(GeneralizedFamily(
    "solve", "A^-1 b — explicit inverse vs LU vs Cholesky solve"))
register_family(GeneralizedFamily(
    "bilinear", "x^T A y — left-first vs right-first association"))
register_family(KernelVariantsFamily())
