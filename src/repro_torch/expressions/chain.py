"""Matrix-chain algorithm generation (paper Expression 1 substrate).

For ``X = M_1 M_2 ... M_n`` every *parenthesization* (full binary tree over
the chain) is a mathematically equivalent variant, and every *linear
extension* of a tree's internal nodes (instruction order) is a distinct
algorithm: e.g. ``(AB)(CD)`` yields two algorithms — compute ``AB`` before or
after ``CD`` (paper Sec. I: "At least six algorithms can be implemented from
the five variants").

This module enumerates trees (Catalan(n-1) of them), their instruction
orders, and exact GEMM FLOP counts (2·m·k·n per product; the paper's Fig. 1
quotes cost = FLOPs/2). It also provides the classic dynamic-programming
optimum for cross-checking that the enumerated minimum matches.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Sequence, Tuple, Union

# A parenthesization tree: leaf = matrix index (int); internal = (left, right).
Tree = Union[int, Tuple["Tree", "Tree"]]

#: A single GEMM instruction: (dest_id, lhs_id, rhs_id). Operand ids are
#: either leaf indices ("M0", "M1", ...) or earlier dest ids ("T0", ...).
Step = Tuple[str, str, str]


def enumerate_trees(n: int) -> List[Tree]:
    """All full binary trees over leaves 0..n-1 (Catalan(n-1) trees)."""
    if n < 1:
        raise ValueError("need at least one matrix")

    @functools.lru_cache(maxsize=None)
    def build(i: int, j: int) -> Tuple[Tree, ...]:
        if i == j:
            return (i,)
        out: List[Tree] = []
        for k in range(i, j):
            for left in build(i, k):
                for right in build(k + 1, j):
                    out.append((left, right))
        return tuple(out)

    return list(build(0, n - 1))


def tree_dims(tree: Tree, dims: Sequence[int]) -> Tuple[int, int]:
    """(rows, cols) of the subexpression; ``dims`` has length n_matrices+1."""
    if isinstance(tree, int):
        return dims[tree], dims[tree + 1]
    (lr, _), (_, rc) = tree_dims(tree[0], dims), tree_dims(tree[1], dims)
    return lr, rc


def tree_flops(tree: Tree, dims: Sequence[int]) -> int:
    """Exact GEMM FLOPs of the parenthesization (2·m·k·n per product)."""
    if isinstance(tree, int):
        return 0
    left, right = tree
    lf = tree_flops(left, dims)
    rf = tree_flops(right, dims)
    (m, k) = tree_dims(left, dims)
    (_, n) = tree_dims(right, dims)
    return lf + rf + 2 * m * k * n


def tree_label(tree: Tree) -> str:
    """Human-readable parenthesization, e.g. ``((M0 M1) M2)``; uses letters
    A.. for chains up to 26 matrices."""
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"

    def render(t: Tree) -> str:
        if isinstance(t, int):
            return letters[t] if t < len(letters) else f"M{t}"
        return f"({render(t[0])}{render(t[1])})"

    s = render(tree)
    return s[1:-1] if s.startswith("(") and s.endswith(")") else s


def _internal_nodes(tree: Tree) -> List[Tuple[Tree, Tree, Tree]]:
    """Post-order list of internal nodes as (node, left, right)."""
    out: List[Tuple[Tree, Tree, Tree]] = []

    def walk(t: Tree) -> None:
        if isinstance(t, int):
            return
        walk(t[0])
        walk(t[1])
        out.append((t, t[0], t[1]))

    walk(tree)
    return out


def linear_extensions(tree: Tree) -> List[Tuple[int, ...]]:
    """All valid instruction orders of the tree's internal nodes.

    Nodes are identified by their index in the post-order list; an order is
    valid iff every node appears after both of its internal children.
    Chains of practical length have few extensions (<= 2 for n=4), but the
    enumeration is general.
    """
    nodes = _internal_nodes(tree)
    index = {id(node): i for i, (node, _, _) in enumerate(nodes)}
    deps: List[set] = []
    for node, left, right in nodes:
        d = set()
        if not isinstance(left, int):
            d.add(index[id(left)])
        if not isinstance(right, int):
            d.add(index[id(right)])
        deps.append(d)

    k = len(nodes)
    results: List[Tuple[int, ...]] = []

    def backtrack(done: Tuple[int, ...], remaining: set) -> None:
        if not remaining:
            results.append(done)
            return
        for i in sorted(remaining):
            if deps[i] <= set(done):
                backtrack(done + (i,), remaining - {i})

    backtrack((), set(range(k)))
    return results


@dataclass(frozen=True)
class ChainAlgorithm:
    """One executable algorithm: a parenthesization + an instruction order."""

    name: str                  # "algorithm3"
    tree: Tree
    label: str                 # e.g. "(AB)(CD) [order CD,AB]"
    steps: Tuple[Step, ...]    # GEMM sequence, dests "T0","T1",...
    flops: int
    out_dims: Tuple[int, int]

    @property
    def n_products(self) -> int:
        return len(self.steps)


def algorithms_for_tree(
    tree: Tree, dims: Sequence[int], start_index: int
) -> List[ChainAlgorithm]:
    """All algorithms (instruction orders) of one parenthesization."""
    nodes = _internal_nodes(tree)
    node_ids = {id(node): i for i, (node, _, _) in enumerate(nodes)}
    flops = tree_flops(tree, dims)
    out_dims = tree_dims(tree, dims)
    base_label = tree_label(tree)

    def operand_name(t: Tree, order_pos: Dict[int, int]) -> str:
        if isinstance(t, int):
            return f"M{t}"
        return f"T{order_pos[node_ids[id(t)]]}"

    algs: List[ChainAlgorithm] = []
    for ext_no, ext in enumerate(linear_extensions(tree)):
        order_pos = {node_idx: pos for pos, node_idx in enumerate(ext)}
        steps: List[Step] = []
        for pos, node_idx in enumerate(ext):
            node, left, right = nodes[node_idx]
            steps.append(
                (
                    f"T{pos}",
                    operand_name(left, order_pos),
                    operand_name(right, order_pos),
                )
            )
        order_suffix = "" if ext_no == 0 else f" [order {ext_no}]"
        algs.append(
            ChainAlgorithm(
                name=f"algorithm{start_index + ext_no}",
                tree=tree,
                label=base_label + order_suffix,
                steps=tuple(steps),
                flops=flops,
                out_dims=out_dims,
            )
        )
    return algs


def generate_chain_algorithms(dims: Sequence[int]) -> List[ChainAlgorithm]:
    """Every algorithm for the chain instance ``dims`` (len = n_matrices+1).

    Algorithms are numbered in (FLOPs, tree-enumeration, extension) order so
    that ``algorithm0`` always computes the least FLOPs — mirroring the
    paper's convention that the minimum-FLOPs variants carry the low indices.
    """
    n = len(dims) - 1
    trees = enumerate_trees(n)
    # Stable sort trees by FLOPs so min-FLOPs algorithms get low indices.
    trees.sort(key=lambda t: tree_flops(t, dims))
    algs: List[ChainAlgorithm] = []
    idx = 0
    for tree in trees:
        tree_algs = algorithms_for_tree(tree, dims, idx)
        algs.extend(tree_algs)
        idx += len(tree_algs)
    return algs


def dp_optimal_flops(dims: Sequence[int]) -> int:
    """Classic O(n^3) matrix-chain DP; exact GEMM FLOPs (2·m·k·n units).

    Used as an oracle: the enumerated minimum must equal this.
    """
    n = len(dims) - 1
    cost = [[0] * n for _ in range(n)]
    for span in range(1, n):
        for i in range(n - span):
            j = i + span
            cost[i][j] = min(
                cost[i][k] + cost[k + 1][j] + 2 * dims[i] * dims[k + 1] * dims[j + 1]
                for k in range(i, j)
            )
    return cost[0][n - 1]


def flops_table(algs: Sequence[ChainAlgorithm]) -> Dict[str, float]:
    return {a.name: float(a.flops) for a in algs}
