"""repro_torch.expressions — matrix-chain variant generation and its
PyTorch workloads.

``chain`` and ``instances`` are copies of the reference's pure-Python
modules (identical algorithm enumeration and FLOP tables); ``algorithms``
runs each algorithm's GEMM sequence on torch tensors; ``generalized`` holds
the beyond-chain families (the reference's FLOP tables, workloads on
``torch.matmul`` and ``torch.linalg``).
"""

from .algorithms import (
    build_algorithm_fn,
    build_workloads,
    inputs_from_reference,
    make_chain_inputs,
    reference_product,
    verify_algorithms,
)
from .chain import (
    ChainAlgorithm,
    algorithms_for_tree,
    dp_optimal_flops,
    enumerate_trees,
    flops_table,
    generate_chain_algorithms,
    linear_extensions,
    tree_dims,
    tree_flops,
    tree_label,
)
from .generalized import (
    FAMILIES,
    ExpressionFamily,
    ExpressionVariant,
    bilinear_family,
    distributive_family,
    gram_family,
    solve_family,
)
from .instances import (
    ANOMALY_331,
    FIG3_75,
    INSTANCE_A,
    INSTANCE_B,
    PAPER_INSTANCES,
    SMOKE_INSTANCES,
    ChainInstance,
    get_instance,
    instance_grid,
    random_instance,
)

__all__ = [
    "ANOMALY_331",
    "ChainAlgorithm",
    "ChainInstance",
    "ExpressionFamily",
    "ExpressionVariant",
    "FAMILIES",
    "FIG3_75",
    "INSTANCE_A",
    "INSTANCE_B",
    "PAPER_INSTANCES",
    "SMOKE_INSTANCES",
    "algorithms_for_tree",
    "bilinear_family",
    "build_algorithm_fn",
    "build_workloads",
    "distributive_family",
    "dp_optimal_flops",
    "enumerate_trees",
    "flops_table",
    "generate_chain_algorithms",
    "get_instance",
    "gram_family",
    "inputs_from_reference",
    "instance_grid",
    "linear_extensions",
    "make_chain_inputs",
    "random_instance",
    "reference_product",
    "solve_family",
    "tree_dims",
    "tree_flops",
    "tree_label",
    "verify_algorithms",
]
