"""repro_torch.train — optimizers, the train step, fault tolerance and
elastic training (the reference's ``train/``), on one device or across
processes on a ``DeviceMesh``."""

from .elastic import ElasticConfig, ElasticTrainer, HostMesh
from .ft import FailureDetector, MembershipEvent, StragglerMonitor, reassign_shards
from .optimizer import (
    Adafactor,
    AdafactorState,
    AdamW,
    AdamWState,
    constant_schedule,
    cosine_schedule,
    global_norm,
)
from .trainer import (
    LossConfig,
    TrainState,
    cross_entropy,
    init_train_state,
    make_loss_fn,
    make_train_step,
    train_state_from_numpy,
)

__all__ = [
    "Adafactor",
    "AdafactorState",
    "AdamW",
    "AdamWState",
    "ElasticConfig",
    "ElasticTrainer",
    "FailureDetector",
    "HostMesh",
    "LossConfig",
    "MembershipEvent",
    "StragglerMonitor",
    "TrainState",
    "constant_schedule",
    "cosine_schedule",
    "cross_entropy",
    "global_norm",
    "init_train_state",
    "make_loss_fn",
    "make_train_step",
    "reassign_shards",
    "train_state_from_numpy",
]
