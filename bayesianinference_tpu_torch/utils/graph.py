"""Model dependency graphs (port of ``bayesianinference_tpu.utils.graph``,
which is pure metadata: the same code, no tensors).

Equivalents of ``modelGraph`` / ``dependencyData``
(BayesianUtilities.wl:721-759): a DAG over model variables with
input/output roles, ancestor/descendant sets, and cycle/dependency
validation as used by ``laplacePosteriorFit`` (LaplaceApproximation.wl:
485-504).  Pure-metadata (no plotting dependency); works with the edge
lists produced by :meth:`~..dists.combinators.ConditionalProduct.graph`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Sequence, Tuple

__all__ = ["ModelGraph", "model_graph", "dependency_data"]


@dataclasses.dataclass(frozen=True)
class ModelGraph:
    """Directed model graph: edges (parent -> child), with declared input
    (independent) and output (dependent) variables — the red/green
    vertices of ``modelGraph`` (BU:744-750)."""

    vertices: Tuple[str, ...]
    edges: Tuple[Tuple[str, str], ...]
    inputs: Tuple[str, ...] = ()
    outputs: Tuple[str, ...] = ()

    def parents(self, v: str) -> List[str]:
        return [p for p, c in self.edges if c == v]

    def children(self, v: str) -> List[str]:
        return [c for p, c in self.edges if p == v]

    def is_acyclic(self) -> bool:
        color: Dict[str, int] = {}

        def visit(v) -> bool:
            color[v] = 1
            for c in self.children(v):
                st = color.get(c, 0)
                if st == 1 or (st == 0 and not visit(c)):
                    return False
            color[v] = 2
            return True

        return all(color.get(v, 0) == 2 or visit(v) for v in self.vertices)

    def topological_order(self) -> List[str]:
        if not self.is_acyclic():
            raise ValueError("cyclic models are not supported")
        out: List[str] = []
        seen = set()

        def visit(v):
            if v in seen:
                return
            seen.add(v)
            for p in self.parents(v):
                visit(p)
            out.append(v)

        for v in self.vertices:
            visit(v)
        return out

    def validate_dependencies(self) -> None:
        """The reference's structural checks (LA:489-504): independent
        variables must have no parents; model parameters (non-input,
        non-output vertices) must not depend on dependent variables."""
        if not self.is_acyclic():
            raise ValueError("cyclic models are not supported")
        for p, c in self.edges:
            if c in self.inputs:
                raise ValueError(
                    f"independent variable {c!r} cannot depend on {p!r}"
                )
            if p in self.outputs and c not in self.outputs:
                raise ValueError(
                    f"model parameter {c!r} cannot depend on dependent "
                    f"variable {p!r}"
                )


def model_graph(
    edges: Sequence[Tuple[str, str]],
    inputs: Sequence[str] = (),
    outputs: Sequence[str] = (),
    extra_vertices: Sequence[str] = (),
) -> ModelGraph:
    """Build the model DAG from (parent, child) edges, marking input and
    output vertices (``modelGraph``, BayesianUtilities.wl:721-751)."""
    verts: List[str] = []
    for p, c in edges:
        for v in (p, c):
            if v not in verts:
                verts.append(v)
    for v in list(inputs) + list(outputs) + list(extra_vertices):
        if v not in verts:
            verts.append(v)
    return ModelGraph(
        vertices=tuple(verts),
        edges=tuple(edges),
        inputs=tuple(inputs),
        outputs=tuple(outputs),
    )


def dependency_data(graph: ModelGraph) -> Dict[str, Dict[str, FrozenSet[str]]]:
    """Per-vertex ancestor/descendant sets (``dependencyData``,
    BU:753-759)."""

    def closure(v, step):
        seen: set = set()
        stack = list(step(v))
        while stack:
            u = stack.pop()
            if u not in seen:
                seen.add(u)
                stack.extend(step(u))
        return frozenset(seen)

    return {
        v: {
            "ancestors": closure(v, graph.parents),
            "descendants": closure(v, graph.children),
        }
        for v in graph.vertices
    }
