"""GCONV Chain IR (paper §3.2).

A :class:`Chain` is an ordered producer/consumer DAG whose nodes are
:class:`~repro_torch.core.gconv.GConv` operations (plus a lightweight ``Concat``
pseudo-node for pure data-movement layers such as GoogLeNet/DenseNet concat).

Node inputs/kernels/operands reference, by name, one of
  * an external chain input      (``chain.inputs``),
  * a learned/constant parameter (``chain.params``),
  * a previous node's output.

Shape discipline: every tensor in a chain is carried with an explicit
N-dimensional *named* layout. A consumer GCONV must agree with its producer
axis-by-axis on the *total* axis sizes (it may re-interpret the grouping of an
axis — e.g. view a size-``C`` axis as ``Ng:C`` where the producer wrote it as
``Nop:C``; that re-interpretation is exactly the paper's Figure 5/Table 2
usage). Kernels and pre/post operands may *broadcast*: a size-1 axis matches
anything (Table 2, e.g. FP4's kernel is the per-channel FP3 output broadcast
over the batch axis).

A copy of the JAX package's ``repro.core.chain``: the IR is framework-free and
identical in both packages, so chains, parameter names and shapes agree
(``tests/test_torch_ir.py`` holds the copy to its original).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .gconv import GConv


@dataclass
class Concat:
    """Concatenation pseudo-node (pure data movement, no arithmetic)."""

    name: str
    inputs: Tuple[str, ...]
    axis: int
    out_shape: Tuple[int, ...] = ()

    @property
    def macs(self) -> int:
        return 0

    @property
    def out_elems(self) -> int:
        n = 1
        for s in self.out_shape:
            n *= s
        return n


@dataclass
class Movement:
    """Transpose-and/or-reshape pseudo-node (pure data movement).

    Applied as: ``y = x.transpose(perm).reshape(out_shape)``. Used to re-view
    tensors between GCONVs whose dim decompositions differ (e.g. (B,T,C) ->
    (B,H,T,D) for the attention chain segment). In hardware terms this is the
    paper's "storage format" concern — the consistent-mapping pass (§4.3)
    tries to make these free by loop exchange; any that remain are charged as
    data movement by the cost model.
    """

    name: str
    input: str
    perm: Optional[Tuple[int, ...]] = None
    out_shape: Tuple[int, ...] = ()
    pre_shape: Optional[Tuple[int, ...]] = None   # reshape before perm
    flip: Tuple[int, ...] = ()                    # axes to reverse (rot180
                                                  # weight views for conv BP)
    gather: bool = False    # element-count-changing movement (RoI gather,
                            # proposal selection): interpreter-opaque, cost
                            # model charges the moved output elements

    @property
    def macs(self) -> int:
        return 0

    @property
    def out_elems(self) -> int:
        n = 1
        for s in self.out_shape:
            n *= s
        return n


Node = Union[GConv, Concat, Movement]


@dataclass
class TensorInfo:
    shape: Tuple[int, ...]
    dtype: str = "float32"


class Chain:
    """An ordered GCONV chain with external inputs and parameters."""

    def __init__(self, name: str):
        self.name = name
        self.inputs: Dict[str, TensorInfo] = {}
        self.params: Dict[str, TensorInfo] = {}
        self.nodes: Dict[str, Node] = {}          # insertion-ordered
        self.outputs: List[str] = []
        # optional per-node metadata (layer provenance, traditional-or-not)
        self.meta: Dict[str, dict] = {}

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add_input(self, name: str, shape: Sequence[int], dtype="float32") -> str:
        if name in self.inputs:
            raise ValueError(f"duplicate input {name!r}")
        self.inputs[name] = TensorInfo(tuple(int(s) for s in shape), dtype)
        return name

    def add_param(self, name: str, shape: Sequence[int], dtype="float32") -> str:
        if name in self.params:
            raise ValueError(f"duplicate param {name!r}")
        self.params[name] = TensorInfo(tuple(int(s) for s in shape), dtype)
        return name

    def fresh(self, base: str) -> str:
        if not self.known(base):
            return base
        i = 1
        # probe all three namespaces: a candidate colliding with an input
        # or param would make add() raise "duplicate node name"
        while self.known(f"{base}_{i}"):
            i += 1
        return f"{base}_{i}"

    def add(self, node: Node, **meta) -> str:
        if node.name in self.nodes or node.name in self.inputs or node.name in self.params:
            raise ValueError(f"duplicate node name {node.name!r}")
        for ref in self._refs(node):
            if not self.known(ref):
                raise ValueError(
                    f"node {node.name!r} references unknown tensor {ref!r}")
        self._check_shapes(node)
        self.nodes[node.name] = node
        if meta:
            self.meta[node.name] = dict(meta)
        return node.name

    def mark_output(self, name: str):
        if name not in self.nodes:
            raise ValueError(f"cannot mark non-node {name!r} as output")
        if name not in self.outputs:
            self.outputs.append(name)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def known(self, ref: str) -> bool:
        return ref in self.inputs or ref in self.params or ref in self.nodes

    def shape_of(self, ref: str) -> Tuple[int, ...]:
        if ref in self.inputs:
            return self.inputs[ref].shape
        if ref in self.params:
            return self.params[ref].shape
        node = self.nodes[ref]
        if isinstance(node, GConv):
            return node.out_shape
        return tuple(node.out_shape)

    @staticmethod
    def _refs(node: Node) -> List[str]:
        if isinstance(node, Concat):
            return list(node.inputs)
        if isinstance(node, Movement):
            return [node.input]
        refs = [node.input]
        if node.kernel is not None:
            refs.append(node.kernel)
        for op in tuple(node.pre) + tuple(node.post):
            if op.operand is not None:
                refs.append(op.operand)
        return refs

    def consumers(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for name, node in self.nodes.items():
            for ref in self._refs(node):
                out.setdefault(ref, []).append(name)
        return out

    def gconv_nodes(self) -> List[GConv]:
        return [n for n in self.nodes.values() if isinstance(n, GConv)]

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def _check_shapes(self, node: Node):
        if isinstance(node, Movement):
            in_shape = self.shape_of(node.input)
            if node.pre_shape is not None:
                n_a = 1
                for s in in_shape:
                    n_a *= s
                n_b = 1
                for s in node.pre_shape:
                    n_b *= s
                if n_a != n_b:
                    raise ValueError(f"{node.name}: pre_shape elems mismatch")
                in_shape = tuple(node.pre_shape)
            if node.perm is not None:
                if sorted(node.perm) != list(range(len(in_shape))):
                    raise ValueError(f"{node.name}: bad perm {node.perm} "
                                     f"for rank {len(in_shape)}")
                in_shape = tuple(in_shape[p] for p in node.perm)
            if not node.out_shape:
                node.out_shape = tuple(in_shape)
            n_in = 1
            for s in in_shape:
                n_in *= s
            n_out = 1
            for s in node.out_shape:
                n_out *= s
            if n_in != n_out and not node.gather:
                raise ValueError(
                    f"{node.name}: movement elems mismatch {in_shape} -> "
                    f"{node.out_shape}")
            return
        if isinstance(node, Concat):
            shapes = [self.shape_of(r) for r in node.inputs]
            base = list(shapes[0])
            for s in shapes[1:]:
                if len(s) != len(base):
                    raise ValueError(f"{node.name}: concat rank mismatch {shapes}")
                for ax, (a, b) in enumerate(zip(base, s)):
                    if ax == node.axis:
                        continue
                    if a != b:
                        raise ValueError(
                            f"{node.name}: concat non-axis mismatch {shapes}")
            base[node.axis] = sum(s[node.axis] for s in shapes)
            node.out_shape = tuple(base)
            return
        # GConv: input must match in_shape exactly; kernel/operands broadcast.
        in_shape = self.shape_of(node.input)
        want = node.in_shape
        if tuple(in_shape) != tuple(want):
            raise ValueError(
                f"{node.name}: input {node.input!r} has shape {in_shape}, "
                f"GCONV dims imply {want} "
                f"({' '.join(d.pretty() for d in node.dims)})")
        if node.kernel is not None:
            k_shape = self.shape_of(node.kernel)
            want_k = node.k_shape
            if len(k_shape) != len(want_k):
                raise ValueError(
                    f"{node.name}: kernel {node.kernel!r} rank {len(k_shape)} "
                    f"!= {len(want_k)}")
            for a, b in zip(k_shape, want_k):
                if a != b and a != 1:
                    raise ValueError(
                        f"{node.name}: kernel {node.kernel!r} shape {k_shape} "
                        f"not broadcastable to {want_k}")
        out_shape = node.out_shape
        for op in tuple(node.pre) + tuple(node.post):
            if op.operand is None:
                continue
            o_shape = self.shape_of(op.operand)
            ref_shape = in_shape if op in node.pre else out_shape
            if len(o_shape) != len(ref_shape):
                raise ValueError(
                    f"{node.name}: operand {op.operand!r} rank mismatch "
                    f"{o_shape} vs {ref_shape}")
            for a, b in zip(o_shape, ref_shape):
                if a != b and a != 1:
                    raise ValueError(
                        f"{node.name}: operand {op.operand!r} shape {o_shape} "
                        f"not broadcastable to {ref_shape}")

    def validate(self):
        """Re-validate the whole chain (used after transformation passes)."""
        seen = set(self.inputs) | set(self.params)
        for name, node in self.nodes.items():
            for ref in self._refs(node):
                if ref not in seen:
                    raise ValueError(
                        f"{name} consumes {ref!r} before production")
            self._check_shapes(node)
            seen.add(name)
        for o in self.outputs:
            if o not in self.nodes:
                raise ValueError(f"output {o!r} is not a node")

    # ------------------------------------------------------------------
    # statistics (paper Table 1)
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        macs = sum(n.macs for n in self.nodes.values())
        data = sum(n.out_elems for n in self.nodes.values())
        n_gconv = sum(1 for n in self.nodes.values() if isinstance(n, GConv))
        trad = sum(
            n.macs for name, n in self.nodes.items()
            if self.meta.get(name, {}).get("traditional", False))
        trad_data = sum(
            n.out_elems for name, n in self.nodes.items()
            if self.meta.get(name, {}).get("traditional", False))
        return dict(
            name=self.name,
            n_nodes=len(self.nodes),
            n_gconv=n_gconv,
            macs=macs,
            intermediate_elems=data,
            traditional_macs=trad,
            nontraditional_macs=macs - trad,
            traditional_elems=trad_data,
            nontraditional_elems=data - trad_data,
        )

    def pretty(self) -> str:
        lines = [f"Chain {self.name!r}  "
                 f"(inputs={list(self.inputs)}, params={len(self.params)}, "
                 f"nodes={len(self.nodes)})"]
        for name, node in self.nodes.items():
            if isinstance(node, Concat):
                lines.append(f"  {name}: concat(axis={node.axis}) "
                             f"{list(node.inputs)} -> {node.out_shape}")
            else:
                lines.append("  " + node.pretty())
        lines.append(f"  outputs: {self.outputs}")
        return "\n".join(lines)
