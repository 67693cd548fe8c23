"""The census: whole shards of the chain family through ``run_shard``.

Each unit is one shard of ``shard_instances`` chain instances, run in
process by ``repro_torch.core.sweep.run_shard`` on the wall-clock backend
into a fresh store under ``TMPDIR`` (the ``census run --workers 1`` path).
The pool is the first ``pool_shards`` shards of a spec whose instance ``i``
has the census's own dimensions; every seed runs the same pool, round
after round, in an order drawn from the seed.

For the window the chain family in the program's registry is replaced by
one that hands out the family's own workloads wrapped: every call the
census makes to them is counted with its frozen FLOPs, and the callables
of a sample of each shard's instances, drawn from the seed, keep what
they last returned.
After the window each record's dimensions, FLOP table and verdict are
recomputed, and those kept outputs are held to the float64 product.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, List

import numpy as np

from .. import formulas, generators as gen, reference
from ..harness import Verdict


class Driver:
    def __init__(self, config, traffic, *, seed, device, tracer, calls):
        from repro_torch.core import family, sweep

        self.sweep, self.family = sweep, family
        self.t = traffic
        self.seed, self.device, self.tracer, self.calls = seed, device, tracer, calls
        self.n = int(config["n_matrices"])
        self.unit_size = int(traffic["shard_instances"])
        pool = int(traffic["pool_shards"])
        self.spec = sweep.SweepSpec(
            name="census",
            families={"chain": {"count": pool * self.unit_size, "n_matrices": [self.n],
                                "lo": int(traffic["lo"]), "hi": int(traffic["hi"])}},
            n_shards=pool, backend="wall_clock", **traffic["census"])
        self.instances = {i.uid: i for i in self.spec.expand()}
        self.order = gen.rounds(seed, 1, pool)
        rng = np.random.default_rng(gen.derive(seed, 3))
        self.kept: Dict[str, Dict] = {}  # sampled uid -> algorithm -> last output
        for shard in range(pool):
            uids = sorted(i.uid for i in self.spec.shard_instances(shard))
            for k in rng.choice(len(uids), size=min(len(uids), int(traffic["check_per_shard"])),
                                replace=False):
                self.kept[uids[k]] = {}
        self.root = tempfile.mkdtemp(prefix="portbench-census-")
        self.records: List[Dict] = []
        self.units = 0
        self.real = family.get_family("chain")

    def setup(self) -> None:
        """Build and run once every algorithm of the first instances of the
        pool (cuBLAS's handle and the kernels these shapes load), then put
        the wrapped family in the registry."""
        for inst in list(self.instances.values())[: int(self.t["warmup_instances"])]:
            _, _, build = self.sweep.instance_entry(inst)
            build(self.device)
        self.family.register_family(_Wrapped(self.real, self))

    def wrap(self, inst, build):
        """``build`` with each workload it returns counted and, for a
        sampled instance, keeping its last output."""
        p = inst.params
        dims = gen.chain_dims(int(p["n_matrices"]), int(p["lo"]), int(p["hi"]), int(p["seed"]))
        flops = {name: f for name, f, _ in formulas.chain_algorithms(dims)}
        keep = self.kept.get(inst.uid)

        def wrapped(device):
            return {name: self.calls.wrap(fn, flops[name], None, keep, name)
                    for name, fn in build(device).items()}

        return wrapped

    def unit(self) -> List[Verdict]:
        shard = next(self.order)
        root = os.path.join(self.root, f"unit{self.units:05d}")
        self.units += 1
        with self.tracer.mark("pb.shard"):
            store = self.sweep.run_shard(self.spec, root, shard, device=self.device)
        records = store.records
        with open(store.timings_path) as fh:
            build_s = json.load(fh)["build_s"] / max(1, len(records))
        self.records.extend(records)
        return [Verdict(latency_s=None, measurements=rec["measurements_per_alg"] * len(rec["ranks"]),
                        build_s=build_s) for rec in records]

    def _dims(self, rec) -> tuple:
        p = self.instances[rec["uid"]].params
        return gen.chain_dims(self.n, int(p["lo"]), int(p["hi"]), int(p["seed"]))

    def release(self) -> None:
        self.family.register_family(self.real)
        shutil.rmtree(self.root, ignore_errors=True)

    def check(self, control: bool = False) -> Dict[str, Dict]:
        dims_faults = verdict_faults = 0
        for rec in self.records:
            dims = self._dims(rec)
            dims_faults += int(list(rec["dims"]) != list(dims))
            flops = {name: float(f) for name, f, _ in formulas.chain_algorithms(dims)}
            verdict_faults += reference.verdict_faults(flops, rec["flops"], rec["ranks"], rec)
        ran = {rec["uid"] for rec in self.records}
        worst = 0.0 if ran & set(self.kept) else float("inf")
        for uid, outs in self.kept.items():
            if uid not in ran:
                continue
            inst = self.instances[uid]
            mats = [m.to(self.device)
                    for m in gen.census_inputs(self._dims({"uid": uid}), int(inst.params["seed"]))]
            ref = reference.chain_product(mats)
            if control:
                outs = {"tf32": reference.chain_tf32(mats)}
            elif len(outs) != len(formulas.chain_algorithms(self._dims({"uid": uid}))):
                outs = {"missing": ref.new_empty(0)}  # an algorithm timed nothing: infinitely wrong
            worst = max([worst] + [reference.rel_max_err(o, ref) for o in outs.values()])
            del outs, ref, mats
        self.kept.clear()
        limits = self.t["limits"]
        return {
            "dims_mismatches": {"value": dims_faults, "limit": 0},
            "verdict_mismatches": {"value": verdict_faults, "limit": 0},
            "product_err": {"value": worst, "limit": limits["product_err"]},
        }


class _Wrapped:
    """The program's chain family, its workloads wrapped by the driver."""

    def __init__(self, real, driver: Driver):
        self.real, self.driver = real, driver

    def __getattr__(self, name):
        return getattr(self.real, name)

    def entry(self, inst):
        flops, meta, build = self.real.entry(inst)
        return flops, meta, self.driver.wrap(inst, build)
