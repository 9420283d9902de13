"""Vertex/edge *type descriptors* and the tag registry.

Where the reference framework uses virtual classes per vertex/edge type
(``g2o/core/base_vertex.h``, ``base_edge.h``) and a string-tag ``Factory``
(``g2o/core/factory.h:47``), the array-program design uses plain descriptor
objects holding pure functions.  A whole *batch* of same-type edges is
evaluated with one ``vmap``-ed residual and one ``jacfwd`` — replacing both
per-edge virtual dispatch and the numeric-differentiation fallback
(``g2o/core/base_binary_edge.hpp:199-240``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class VertexType:
    """A manifold vertex type.

    Attributes:
      name: unique name, also the default ``.g2o`` tag.
      rep_dim: length of the stored state vector (e.g. 7 for SE3 = t+quat).
      tangent_dim: minimal dof of the local perturbation (e.g. 6 for SE3).
      oplus: ``(state, delta) -> state`` applying a tangent perturbation;
        must be pure jnp and vmappable (reference ``Vertex::oplus``,
        ``g2o/core/optimizable_graph.h:258``).
      to_vector / from_vector: conversion between the stored representation
        and the ``.g2o`` serialisation (identity by default).
      tags: accepted ``.g2o`` tags when loading.
    """

    name: str
    rep_dim: int
    tangent_dim: int
    oplus: Callable
    to_vector: Optional[Callable] = None
    from_vector: Optional[Callable] = None
    tags: Sequence[str] = ()
    io_dim: Optional[int] = None  # numbers in the .g2o line (default rep_dim)

    @property
    def io_tags(self):
        return tuple(self.tags) if self.tags else (self.name,)

    @property
    def serialized_dim(self) -> int:
        return self.rep_dim if self.io_dim is None else self.io_dim


@dataclasses.dataclass(frozen=True)
class EdgeType:
    """An error-function (hyper-)edge type connecting fixed vertex types.

    Attributes:
      name: unique name, also the default ``.g2o`` tag.
      vertex_types: the types of the connected vertices, in slot order.
      residual_dim: error dimension r.
      residual: ``(states: tuple, measurement, param) -> (r,)`` pure fn
        (reference ``Edge::computeError``).
      meas_dim: length of the stored measurement vector.
      param_dim: length of the per-edge parameter vector (0 if none) — the
        analogue of resolved ``g2o::Parameter`` blocks
        (``g2o/core/parameter.h:36``).
      meas_to_vector / meas_from_vector: .g2o serialisation of measurement.
      jacobian: optional analytic jacobian ``(states, meas, param) ->
        tuple[(r, d_i)]``; when None, forward-mode autodiff of the residual
        composed with each vertex ``oplus`` at zero perturbation is used.
      tags: accepted ``.g2o`` tags when loading.
    """

    name: str
    vertex_types: Sequence[VertexType]
    residual_dim: int
    residual: Callable
    meas_dim: int
    param_dim: int = 0
    jacobian: Optional[Callable] = None
    meas_to_vector: Optional[Callable] = None
    meas_from_vector: Optional[Callable] = None
    tags: Sequence[str] = ()
    meas_io_dim: Optional[int] = None  # numbers in the .g2o line (default meas_dim)
    # optional information-matrix transforms between the on-disk and the
    # stored (error-space) coordinates, ``(info, measurement) -> info`` —
    # the analogue of EdgeSE3Euler's Euler<->quat info conversion
    # (``types/slam3d_addons/edge_se3_euler.cpp:58-104``)
    info_from_io: Optional[Callable] = None
    info_to_io: Optional[Callable] = None
    num_params: int = 1  # how many parameter ids this edge references
    # (their value vectors are concatenated into the param argument;
    # analogue of Edge::numParameters, ``g2o/core/optimizable_graph.h``)
    dynamic_tag: Optional[str] = None  # variable-arity .g2o tag: serialized
    # as 'TAG id... || count meas info' (reference dynamic multi-edge
    # convention, ``core/optimizable_graph.cpp:575-590``)

    @property
    def num_slots(self) -> int:
        return len(self.vertex_types)

    @property
    def serialized_meas_dim(self) -> int:
        return self.meas_dim if self.meas_io_dim is None else self.meas_io_dim

    @property
    def io_tags(self):
        return tuple(self.tags) if self.tags else (self.name,)


class TypeRegistry:
    """String-tag registry mapping ``.g2o`` tags to descriptors — the
    JAX analogue of the reference ``Factory``
    (``g2o/core/factory.h:47,164-178``)."""

    def __init__(self):
        self.vertex_types: dict[str, VertexType] = {}
        self.edge_types: dict[str, EdgeType] = {}
        self._vertex_by_tag: dict[str, VertexType] = {}
        self._edge_by_tag: dict[str, EdgeType] = {}
        self._dynamic_edge_by_tag: dict[str, Callable] = {}

    def register_vertex(self, vt: VertexType) -> VertexType:
        self.vertex_types[vt.name] = vt
        for tag in vt.io_tags:
            self._vertex_by_tag[tag] = vt
        return vt

    def register_edge(self, et: EdgeType) -> EdgeType:
        self.edge_types[et.name] = et
        for tag in et.io_tags:
            self._edge_by_tag[tag] = et
        return et

    def vertex_for_tag(self, tag: str) -> Optional[VertexType]:
        return self._vertex_by_tag.get(tag)

    def edge_for_tag(self, tag: str) -> Optional[EdgeType]:
        return self._edge_by_tag.get(tag)

    def alias_tag(self, alias: str, existing_tag: str) -> None:
        """Accept ``alias`` wherever ``existing_tag`` is accepted — used for
        the reference's deprecated tag spellings (``DEPRECATED_*``,
        ``types/deprecated/slam3d/types_slam3d.cpp:39-52``)."""
        vt = self._vertex_by_tag.get(existing_tag)
        if vt is not None:
            self._vertex_by_tag[alias] = vt
            return
        et = self._edge_by_tag.get(existing_tag)
        if et is not None:
            self._edge_by_tag[alias] = et
            return
        raise KeyError(f"alias target {existing_tag!r} not registered")

    def register_dynamic_edge(self, tag: str, factory: Callable) -> None:
        """``factory(k: int) -> EdgeType`` builds the arity-``k`` specialized
        type for a variable-arity tag (reference ``e->resize(numV)`` path,
        ``core/optimizable_graph.cpp:575-590``)."""
        self._dynamic_edge_by_tag[tag] = factory

    def dynamic_edge_for_tag(self, tag: str) -> Optional[Callable]:
        return self._dynamic_edge_by_tag.get(tag)

    def known_tags(self):
        return sorted(set(self._vertex_by_tag) | set(self._edge_by_tag)
                      | set(self._dynamic_edge_by_tag))


# the global registry (type libraries register into it at import time)
REGISTRY = TypeRegistry()


def register_vertex(vt: VertexType) -> VertexType:
    return REGISTRY.register_vertex(vt)


def register_edge(et: EdgeType) -> EdgeType:
    return REGISTRY.register_edge(et)


def upper_triangular_to_full(vals: Sequence[float], dim: int) -> np.ndarray:
    """Expand the row-major upper-triangular information entries used by the
    ``.g2o`` format into a full symmetric matrix."""
    m = np.zeros((dim, dim))
    k = 0
    for i in range(dim):
        for j in range(i, dim):
            m[i, j] = vals[k]
            m[j, i] = vals[k]
            k += 1
    return m


def full_to_upper_triangular(m: np.ndarray) -> list:
    dim = m.shape[0]
    return [m[i, j] for i in range(dim) for j in range(i, dim)]
