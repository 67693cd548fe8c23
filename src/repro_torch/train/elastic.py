"""Elastic training: survive membership changes by re-meshing + resuming
(the reference's ``train/elastic.py``, on one device).

Recovery contract, as the reference's:

1. membership change detected (failure / join / straggler eviction);
2. rebuild the mesh over the surviving hosts — the DP width changes, the
   model (TP) width is preserved;
3. restore the latest checkpoint onto the new mesh (the checkpoint layer is
   mesh-agnostic);
4. continue from the checkpointed step — the deterministic pipeline
   regenerates exactly the right batches for the new shard layout.

On one card the mesh is a record of axis widths over the one device
(:class:`HostMesh`): the data-parallel width is simulated, as the
reference's single-host launcher simulates hosts as data-parallel groups,
and every step trains on the whole global batch, which no width changes.
``DeviceMesh`` / DTensor sharding plans exist (``repro_torch.distributed``,
``launch/{mesh,specs}.py``); re-meshing the trainer across processes on a
real ``DeviceMesh`` is not ported yet. A restore first drops the live state, then reads the checkpoint into a state
shaped on the ``meta`` device, so two full states are never held at once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import SyntheticLM
from ..device import DeviceLike, resolve_device
from ..models import ForwardOptions, ModelConfig, init_encdec_params, init_lm_params
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


class ElasticTrainer:
    def __init__(
        self,
        cfg: ModelConfig,
        optimizer: AdamW,
        data: SyntheticLM,
        ckpt: CheckpointManager,
        make_mesh_fn: Callable[[int], HostMesh],   # n_hosts -> mesh
        opts: ForwardOptions = ForwardOptions(),
        elastic_cfg: ElasticConfig = ElasticConfig(),
        device: DeviceLike = "cuda",
    ) -> None:
        self.cfg = cfg
        self.optimizer = optimizer
        self.data = data
        self.ckpt = ckpt
        self.make_mesh_fn = make_mesh_fn
        self.opts = opts
        self.ecfg = elastic_cfg
        self.device = resolve_device(device)
        self.mesh: Optional[HostMesh] = None
        self.state: Optional[TrainState] = None
        self.step = 0
        self._step_fn = make_train_step(cfg, optimizer, opts)

    # ------------------------------------------------------------- setup --
    def _make_mesh(self, n_hosts: int) -> HostMesh:
        mesh = self.make_mesh_fn(n_hosts)
        dp = mesh.shape["data"]
        if self.data.cfg.global_batch % dp:
            raise ValueError(f"global batch {self.data.cfg.global_batch} !% data width {dp}")
        return mesh

    def _state_like(self) -> TrainState:
        """The train state's structure, shapes and dtypes, on the meta
        device (no memory)."""
        init = init_encdec_params if self.cfg.is_encoder_decoder else init_lm_params
        params, _ = init(self.cfg, device="meta")
        return init_train_state(self.cfg, self.optimizer, params)

    def _restore(self) -> Optional[Dict[str, Any]]:
        restored = self.ckpt.restore_latest(self._state_like(), device=self.device)
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
        else:
            self.state = init_train_state(self.cfg, self.optimizer, init_params_fn())
            self.step = 0

    # -------------------------------------------------------------- train --
    def run(
        self,
        n_steps: int,
        membership_events: Optional[Dict[int, int]] = None,
    ) -> List[Dict[str, float]]:
        """Train ``n_steps``; ``membership_events[step] = new_n_hosts``
        triggers an elastic re-mesh BEFORE that step."""
        if self.state is None:
            raise RuntimeError("call start() first")
        membership_events = membership_events or {}
        history: List[Dict[str, float]] = []
        target = self.step + n_steps

        while self.step < target:
            if self.step in membership_events:
                self._remesh(membership_events.pop(self.step))

            self.state, metrics = self._step_fn(self.state, self.data.global_batch(self.step))
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step"] = self.step
            history.append(metrics)

            if (self.step + 1) % self.ecfg.checkpoint_every == 0:
                self.ckpt.save(
                    self.step, self.state, extra={"next_step": self.step + 1}
                )
            self.step += 1
        return history

    # ------------------------------------------------------------ elastic --
    def _remesh(self, n_hosts: int) -> None:
        """Membership changed: checkpoint, rebuild mesh, restore, continue."""
        self.ckpt.save(self.step - 1, self.state, extra={"next_step": self.step})
        self.ckpt.wait()
        self.mesh = self._make_mesh(n_hosts)
        self.state = None
        if self._restore() is None:
            raise RuntimeError(f"no checkpoint in {self.ckpt.directory} after saving one")
