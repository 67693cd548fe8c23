"""paper-chain — the paper's OWN workload: matrix-chain instances of
Expression 1 (X = ABCD) whose algorithm variants are ranked by the core
methodology. Exposed through the same registry so drivers can run
``--arch paper-chain``.
"""

from repro_torch.expressions import PAPER_INSTANCES, SMOKE_INSTANCES, ChainInstance

FULL_INSTANCES = {k: ChainInstance(k, v) for k, v in PAPER_INSTANCES.items()}
SMOKE_INSTANCES_ = {k: ChainInstance(k, v) for k, v in SMOKE_INSTANCES.items()}


def get_instances(smoke: bool = False):
    return SMOKE_INSTANCES_ if smoke else FULL_INSTANCES
