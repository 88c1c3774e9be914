"""Theorem 1 — edge-collision probability and per-query accuracy bounds
(port of ``repro.core.theory``: the paper's Eq. 5-11, plain floats), so
measured collision and error rates can be held to the guarantee.
"""

from __future__ import annotations

import math

from .types import LSketchConfig


def p_no_collision(num_edges: int, d_v: int, D: int, L: int, n_labels: int) -> float:
    """Eq. 11: probability that a given edge suffers no collision, under
    uniformly distributed node labels.

    D = d*F (vertex hash range), L = t*F (label hash range — we use
    L = n_blocks * F since labels address blocks), n_labels = #distinct node
    labels.
    """
    l = max(1, n_labels)
    a = (L + l - 1) / (D * L * l)
    return math.exp(-(a * a) * max(0, num_edges - d_v) - a * d_v)


def p_no_collision_cfg(cfg: LSketchConfig, num_edges: int, d_v: int,
                       n_labels: int) -> float:
    D = cfg.b * cfg.F  # within-block vertex address range
    L = cfg.n_blocks * cfg.F
    return p_no_collision(num_edges, d_v, D, L, n_labels)


def edge_query_accuracy(cfg: LSketchConfig, num_edges: int, d_v: int,
                        n_labels: int, n_edge_labels: int | None = None) -> float:
    """§4.2: P (label-free) or P * (1 - 1/c)^(l-1) (label-restricted)."""
    p = p_no_collision_cfg(cfg, num_edges, d_v, n_labels)
    if n_edge_labels is None:
        return p
    return p * (1.0 - 1.0 / cfg.c) ** max(0, n_edge_labels - 1)


def vertex_query_accuracy(cfg: LSketchConfig, num_edges: int, num_vertices: int,
                          d_v: int, n_labels: int,
                          n_edge_labels: int | None = None) -> float:
    """§4.1: P^(|V| - d_v), optionally with the edge-label factor."""
    p = p_no_collision_cfg(cfg, num_edges, d_v, n_labels)
    acc = p ** max(0, num_vertices - d_v)
    if n_edge_labels is not None:
        acc *= (1.0 - 1.0 / cfg.c) ** max(0, n_edge_labels - 1)
    return acc


def subgraph_query_accuracy(cfg: LSketchConfig, num_edges: int, d_v: int,
                            n_labels: int, subgraph_size: int,
                            n_edge_labels: int | None = None) -> float:
    """§4.4: P^v, optionally with the edge-label factor."""
    p = p_no_collision_cfg(cfg, num_edges, d_v, n_labels)
    acc = p ** subgraph_size
    if n_edge_labels is not None:
        acc *= (1.0 - 1.0 / cfg.c) ** max(0, n_edge_labels - 1)
    return acc
