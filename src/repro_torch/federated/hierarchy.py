"""Two-tier (edge -> server) aggregation for cross-device populations (port
of ``repro.federated.hierarchy``).

At 10^4+ clients a single server cannot terminate every upload; real
cross-device systems interpose regional *edge aggregators*: each edge
reduces its region's client updates to one summary, and the server merges
only the E edge summaries. This module implements that topology over the
async engine's buffer flush while preserving the flat merge's numerics:

* clients are assigned to edges in contiguous blocks
  (:func:`edge_assignments`: client ``ci`` belongs to edge ``ci * E // C``,
  the "region = id range" placement);
* each edge computes the *partial weighted sum* of its buffered payloads,
  ``s_e = sum_{i in e} w_i * x_i`` (:func:`build_edge_summary_fn`, one
  contraction per edge and flush), where ``w_i`` are exactly the flat
  merge's weights: normalized staleness-discounted FedAvg weights in
  buffered mode, absolute server-lr-scaled rates in delta mode;
* the server merges the stacked summaries with *unit* edge weights through
  the existing merges (``engine.gal_weighted_merge`` / ``gal_delta_merge``):
  ``sum_e 1.0 * s_e = sum_i w_i * x_i``, so the two-tier result equals the
  flat merge up to float reassociation across edges, and with one edge it
  is *bit-exact*: the edge summary is the same f32 ``tensordot`` the flat
  merge runs, and contracting a single summary with weight 1.0 is exact.

Comm accounting is unchanged by the topology: each client's round trip is
charged per completion exactly as in the flat configuration (the edge->
server legs aggregate E summaries regardless of cohort size and are not
part of the paper's per-client accounting).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """Topology of the two-tier aggregation.

    ``num_edges=1`` is the degenerate single-aggregator topology: the edge
    tier reduces the whole buffer and the server applies it with weight
    1.0, bit-exact to the flat merge.

    ``assignments`` optionally pins an explicit client→edge map (one edge
    id per client, each in ``[0, num_edges)``) instead of the default
    balanced contiguous blocks of :func:`edge_assignments`. Empty edges are
    fine (the merge skips them); the map's length is validated against the
    population at reduce time.
    """

    num_edges: int = 1
    assignments: Any = None

    def __post_init__(self):
        if self.num_edges < 1:
            raise ValueError("num_edges must be >= 1")
        if self.assignments is not None:
            a = np.asarray(self.assignments, np.int64)
            if a.ndim != 1 or a.size < 1:
                raise ValueError("assignments must be a 1-D sequence of edge ids")
            if np.any(a < 0) or np.any(a >= self.num_edges):
                raise ValueError(
                    f"assignments must lie in [0, {self.num_edges}); "
                    f"got values in [{a.min()}, {a.max()}]"
                )
            # frozen dataclass: a hashable tuple keeps configs usable as keys
            object.__setattr__(self, "assignments", tuple(int(x) for x in a))


def get_hierarchy(spec: Any) -> HierarchyConfig:
    """Coerce ``None`` / int / HierarchyConfig to a HierarchyConfig."""
    if spec is None:
        return HierarchyConfig()
    if isinstance(spec, HierarchyConfig):
        return spec
    if isinstance(spec, int):
        return HierarchyConfig(num_edges=spec)
    raise TypeError(f"hierarchy must be an int or HierarchyConfig, got {type(spec)!r}")


def edge_assignments(num_clients: int, num_edges: int) -> np.ndarray:
    """(num_clients,) edge id per client: contiguous blocks, sizes within 1.

    ``edge(ci) = ci * E // C``, the balanced block partition. More edges
    than clients leaves the trailing edges empty, which the merge skips.
    """
    if num_clients < 1 or num_edges < 1:
        raise ValueError("num_clients and num_edges must be >= 1")
    return (np.arange(num_clients, dtype=np.int64) * num_edges) // num_clients


def build_edge_summary_fn() -> Callable:
    """The edge-tier reduction: ``(stacked payloads (k_e, ...), weights
    (k_e,) f32) -> partial weighted sum`` per leaf. The same contraction as
    the flat merge over the whole buffer (each payload cast to f32 first),
    restricted to one edge's slice: that is what makes the one-edge
    topology bit-exact."""
    return lambda stacked, w: tree_map(
        lambda x: torch.tensordot(w, x.to(torch.float32), dims=1), stacked
    )


def edge_reduce(
    summary_fn: Callable,
    payloads: Sequence[Any],
    weights: np.ndarray,
    clients: Sequence[int],
    num_clients: int,
    num_edges: int,
    assignments: Any = None,
) -> Tuple[Any, torch.Tensor]:
    """Reduce a flush's payloads through the edge tier.

    Returns ``(stacked_summaries (E', ...), edge_weights (E',) of ones)``
    ready for the server merges; ``E'`` counts the edges with at least one
    buffered completion. ``weights`` are the flat merge weights (already
    staleness-discounted and, in buffered mode, normalized), cast to f32 as
    the flat path casts them. ``assignments`` overrides the default
    contiguous client→edge map; it must cover the whole population.
    """
    if len(payloads) != len(clients) or len(payloads) != len(weights):
        raise ValueError("payloads, weights, and clients must align")
    if assignments is None:
        edges = edge_assignments(num_clients, num_edges)
    else:
        edges = np.asarray(assignments, np.int64)
        if edges.shape != (num_clients,):
            raise ValueError(
                f"assignments must map all {num_clients} clients, got shape {edges.shape}"
            )
        if np.any(edges < 0) or np.any(edges >= num_edges):
            raise ValueError(f"assignments must lie in [0, {num_edges})")
    w32 = np.asarray(weights, np.float32)
    summaries: List[Any] = []
    device = None
    for e in range(num_edges):
        idx = [i for i, ci in enumerate(clients) if edges[int(ci)] == e]
        if not idx:
            continue
        stacked = tree_map(lambda *xs: torch.stack(xs), *[payloads[i] for i in idx])
        device = tree_leaves(stacked)[0].device
        summaries.append(summary_fn(stacked, torch.as_tensor(w32[idx], device=device)))
    stacked_s = tree_map(lambda *xs: torch.stack(xs), *summaries)
    return stacked_s, torch.ones(len(summaries), dtype=torch.float32, device=device)
