"""Elastic training: survive membership changes by re-meshing + resuming
(the reference's ``train/elastic.py``).

Recovery contract, as the reference's:

1. membership change detected (failure / join / straggler eviction);
2. rebuild the mesh over the surviving hosts — the DP width changes, the
   model (TP) width is preserved (TP groups must stay intact; a failed host
   inside a TP group removes the whole group);
3. restore the latest checkpoint onto the new mesh, re-sharded by freshly
   derived shardings (the checkpoint layer is mesh-agnostic);
4. continue from the checkpointed step — the deterministic pipeline
   regenerates exactly the right batches for the new shard layout.

The mesh is what ``make_mesh_fn(n_hosts)`` returns:

* a ``DeviceMesh`` (the reference's ``Mesh``), one rank a device: the state
  is DTensors laid out by ``make_plan(cfg, mesh, mode="train")`` (the
  optimizer's master, mu and nu follow the params; its step counter is a
  host tensor, the same on every rank), batches are sharded by
  ``batch_spec`` and a step runs under ``implicit_replication``. Given an
  :class:`~repro_torch.launch.compat.ElasticGroup`, a membership change
  re-forms the process group over the ranks the new mesh holds
  (``mesh_size_fn(n_hosts)`` of them: ranks ``0 … n-1``); the others
  return their history from :meth:`ElasticTrainer.run` and leave. Without
  one the new mesh is built over the same group.
* a :class:`HostMesh`, a record of axis widths over one device: the
  data-parallel width is simulated, as the reference's single-host
  launcher simulates hosts as data-parallel groups, and every step trains
  on the whole global batch, which no width changes.

A restore first drops the live state, then reads the checkpoint into a
state shaped on the ``meta`` device, so two full states are never held at
once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import SyntheticLM
from ..device import DeviceLike, resolve_device
from ..models import ForwardOptions, ModelConfig, init_encdec_params, init_lm_params
from ..models.layers import is_dtensor
from .optimizer import AdamW
from .trainer import TrainState, init_train_state, make_train_step

Pytree = Any


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """Axis widths over one device: ``data`` simulated data-parallel
    groups, ``model`` the model width (``shape`` as a mesh's)."""

    data: int
    model: int = 1

    @property
    def shape(self) -> Mapping[str, int]:
        return {"data": self.data, "model": self.model}


@dataclasses.dataclass
class ElasticConfig:
    checkpoint_every: int = 10
    keep: int = 3


def _scalar(v: Any) -> float:
    return float(v.full_tensor() if is_dtensor(v) else v)


class ElasticTrainer:
    def __init__(
        self,
        cfg: ModelConfig,
        optimizer: AdamW,
        data: SyntheticLM,
        ckpt: CheckpointManager,
        make_mesh_fn: Callable[[int], Any],   # n_hosts -> DeviceMesh or HostMesh
        opts: ForwardOptions = ForwardOptions(),
        elastic_cfg: ElasticConfig = ElasticConfig(),
        device: DeviceLike = "cuda",
        group: Any = None,                    # launch.compat.ElasticGroup
        mesh_size_fn: Optional[Callable[[int], int]] = None,   # n_hosts -> ranks of its mesh
    ) -> None:
        if group is not None and mesh_size_fn is None:
            raise ValueError("an elastic group needs mesh_size_fn: the ranks the mesh for n hosts holds")
        self.cfg = cfg
        self.optimizer = optimizer
        self.data = data
        self.ckpt = ckpt
        self.make_mesh_fn = make_mesh_fn
        self.opts = opts
        self.ecfg = elastic_cfg
        self.device = resolve_device(device)
        self.group = group
        self.mesh_size_fn = mesh_size_fn
        self.mesh: Any = None
        self.state: Optional[TrainState] = None
        self.step = 0
        self.left = False                 # this rank left at a membership change
        self.recoveries: List[Dict[str, float]] = []   # seconds of each re-mesh's phases
        self._step_fn = make_train_step(cfg, optimizer, opts)

    # ------------------------------------------------------------- setup --
    @property
    def _sharded(self) -> bool:
        return not isinstance(self.mesh, HostMesh)

    def _make_mesh(self, n_hosts: int) -> Any:
        from ..launch.compat import mesh_axis_sizes

        mesh = self.make_mesh_fn(n_hosts)
        sizes = mesh_axis_sizes(mesh)
        dp = sizes.get("pod", 1) * sizes["data"]
        if self.data.cfg.global_batch % dp:
            raise ValueError(f"global batch {self.data.cfg.global_batch} !% data width {dp}")
        return mesh

    def _state_like(self) -> Tuple[TrainState, Any]:
        """The train state's structure, shapes and dtypes on the ``meta``
        device (no memory), and the params' logical axes."""
        init = init_encdec_params if self.cfg.is_encoder_decoder else init_lm_params
        params, axes = init(self.cfg, device="meta")
        return init_train_state(self.cfg, self.optimizer, params), axes

    def _shardings(self, like: TrainState, axes: Any) -> Optional[TrainState]:
        """The state's shardings on the current mesh (None on a HostMesh):
        the reference's ``_shardings``."""
        if not self._sharded:
            return None
        from ..distributed.sharding import make_plan, tree_shardings

        param_sh = tree_shardings(make_plan(self.cfg, self.mesh, mode="train"), axes, like.params)
        opt_sh = type(like.opt)(step=None, master=param_sh, mu=param_sh, nu=param_sh)
        return TrainState(params=param_sh, opt=opt_sh)

    def _restore(self) -> Optional[Dict[str, Any]]:
        like, axes = self._state_like()
        restored = self.ckpt.restore_latest(like, device=self.device, shardings=self._shardings(like, axes))
        if restored is None:
            return None
        self.state, step, extra = restored
        return {"step": step, **extra}

    def start(self, n_hosts: int, init_params_fn: Callable[[], Pytree]) -> None:
        """Fresh start or auto-resume from the latest checkpoint."""
        self.mesh = self._make_mesh(n_hosts)
        restored = self._restore()
        if restored is not None:
            self.step = int(restored.get("next_step", restored["step"] + 1))
            return
        params = init_params_fn()
        if self._sharded:
            from ..distributed.sharding import shard_tree

            like, axes = self._state_like()
            params = shard_tree(params, self._shardings(like, axes).params)
        self.state = init_train_state(self.cfg, self.optimizer, params)
        self.step = 0

    # -------------------------------------------------------------- train --
    def _batch(self, step: int) -> Dict[str, Any]:
        batch = self.data.global_batch(step)
        if not self._sharded:
            return batch
        from ..distributed.sharding import NamedSharding, batch_spec, shard_tensor

        bsh = NamedSharding(self.mesh, batch_spec(self.mesh, self.data.cfg.global_batch, 1))
        return {k: shard_tensor(torch.as_tensor(v, device=self.device), bsh) for k, v in batch.items()}

    def _train_step(self) -> Dict[str, float]:
        """One step; only floats outlive it (no DTensor of the mesh)."""
        if self._sharded:
            from ..launch.compat import implicit_replication

            replication = implicit_replication()
        else:
            replication = contextlib.nullcontext()
        with replication:
            self.state, metrics = self._step_fn(self.state, self._batch(self.step))
        return {k: _scalar(v) for k, v in metrics.items()}

    def run(
        self,
        n_steps: int,
        membership_events: Optional[Dict[int, int]] = None,
    ) -> List[Dict[str, float]]:
        """Train ``n_steps``; ``membership_events[step] = new_n_hosts``
        triggers an elastic re-mesh BEFORE that step. On a rank that the
        new mesh leaves out the history ends there (``self.left``)."""
        if self.state is None:
            raise RuntimeError("call start() first")
        membership_events = membership_events or {}
        history: List[Dict[str, float]] = []
        target = self.step + n_steps

        while self.step < target:
            if self.step in membership_events:
                if not self._remesh(membership_events.pop(self.step)):
                    return history

            metrics = self._train_step()
            metrics["step"] = self.step
            history.append(metrics)

            if (self.step + 1) % self.ecfg.checkpoint_every == 0:
                self.ckpt.save(
                    self.step, self.state, extra={"next_step": self.step + 1}
                )
            self.step += 1
        return history

    # ------------------------------------------------------------ elastic --
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _remesh(self, n_hosts: int) -> bool:
        """Membership changed: checkpoint, drop the state, re-form the group
        (given one), rebuild the mesh, restore, continue. Returns whether
        this rank is in the new mesh."""
        t0 = time.perf_counter()
        self.ckpt.save(self.step - 1, self.state, extra={"next_step": self.step})
        self.ckpt.wait()
        t1 = time.perf_counter()
        self.state = None
        self.mesh = None
        if self.group is not None:
            if not self.group.reform(self.mesh_size_fn(n_hosts)):
                self.left = True
                return False
        self.mesh = self._make_mesh(n_hosts)
        t2 = time.perf_counter()
        if self._restore() is None:
            raise RuntimeError(f"no checkpoint in {self.ckpt.directory} after saving one")
        self._sync()
        self.recoveries.append({"step": self.step, "save_s": t1 - t0, "reform_s": t2 - t1,
                                "restore_s": time.perf_counter() - t2})
        return True
