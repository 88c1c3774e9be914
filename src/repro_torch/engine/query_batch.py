"""Batched query frontend over the objects — arrays in, arrays out (port of
``repro.engine.query_batch``).

A thin adapter: it takes an object (``LSketch``, ``GSS`` or ``LGS``) and
answers through ``repro_torch.sketch.query`` on the object's own 1-shard
handle, so one implementation holds the normalization, the padding, the
path choice and the GSS and LGS rules, and the window planes of the
kernel path are cached on the handle until the object's next insert. The
scalar methods attached in ``core/queries.py`` sit on top (a scalar is a
length-1 batch).
"""

from __future__ import annotations


def edge_weight_batch(sketch, src, src_label, dst, dst_label,
                      edge_label=None, last: int | None = None,
                      path: str = "auto"):
    """Estimated weight of every (src[i], dst[i]) edge: int32 [B]."""
    from repro_torch.sketch import QueryBatch, query
    return query(sketch.spec, sketch.handle, QueryBatch.edges(
        src, src_label, dst, dst_label, edge_label=edge_label, last=last),
        path=path)


def vertex_weight_batch(sketch, vertex, vertex_label, edge_label=None,
                        direction: str = "out", last: int | None = None,
                        path: str = "auto"):
    """Aggregated out/in edge weight of every vertex[i]: int32 [B]."""
    from repro_torch.sketch import QueryBatch, query
    return query(sketch.spec, sketch.handle, QueryBatch.vertices(
        vertex, vertex_label, edge_label=edge_label, direction=direction,
        last=last), path=path)


def label_aggregate_batch(sketch, vertex_label, edge_label=None,
                          direction: str = "out", last: int | None = None,
                          path: str = "auto"):
    """Aggregate weight of all vertices with label lv[i]: int32 [B]. LSketch
    and GSS only: LGS cells mix every label (raises
    ``NotImplementedError``)."""
    from repro_torch.sketch import QueryBatch, query
    return query(sketch.spec, sketch.handle, QueryBatch.labels(
        vertex_label, edge_label=edge_label, direction=direction, last=last),
        path=path)


def scalarize(x, scalar_input: bool):
    """Frontend convention: scalar query in -> python int out."""
    return int(x[0]) if scalar_input else x.cpu().numpy()
