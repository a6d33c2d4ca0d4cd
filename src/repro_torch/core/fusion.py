"""Operation fusion (paper §4.3).

"We apply operation fusion by fusing the GCONVs with no *reduce* operator
into the pre, post or main operators of their consumer or producer. [...]
Since the outputs only need to be processed once, fusing to the post operator
is preferred. After fusion, the pre and post operators may have more than one
parameter."

A GCONV is *fusible* when it performs no reduction (all ``Nks==1``, reduce ==
'none') and no replication (all ``Nop==1`` — its output is elementwise in its
input). Two directions, tried in order:

  1. **producer-post** (preferred): if its input is a GCONV node whose sole
     consumer it is, its pre/main/post collapse into the producer's ``post``
     sequence (the elementwise kernel, if any, becomes a tensor-operand
     ``post`` op — this is how FP2's ``-mu`` rides on FP1's output path).
  2. **consumer-pre**: otherwise, if every consumer reads it as ``input``,
     its operation is replicated into each consumer's ``pre`` sequence
     (paper: "FP2 can be processed as the pre of FP3 and FP4").

Either way one intermediate tensor is never materialized in the global
buffer; the eliminated movement is returned for the Fig.-18-style benchmark.

A copy of the JAX package's ``repro.core.fusion``: the IR is framework-free and
identical in both packages, so chains, parameter names and shapes agree
(``tests/test_torch_ir.py`` holds the copy to its original).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .chain import Chain
from .gconv import GConv, Op

# main operators expressible as a unary op with a tensor operand
_MAIN_AS_UNARY = {"mul": "mul", "add": "add", "sub": "sub", "rsub": "rsub",
                  "div": "div", "max": "maximum"}


@dataclass
class FusionReport:
    before_len: int
    after_len: int
    fused: List[str]
    saved_elems: int
    # surviving node -> the fusible nodes absorbed into it (transitively).
    # The cycle-level simulator (repro.sim) uses these groups: members stream
    # tile-by-tile through their host's pre/post operators and never make a
    # global-buffer round trip. The compiled execution engine (repro.exec)
    # uses the same groups as its unit of dispatch: one group = one emitted
    # step whose member operations run as fused pre/post sequences.
    groups: Dict[str, List[str]] = field(default_factory=dict)

    @property
    def length_reduction(self) -> float:
        return 1.0 - self.after_len / max(1, self.before_len)


@dataclass(frozen=True)
class ExecGroup:
    """One execution partition of a fused chain: the surviving ``host`` node
    plus the fused nodes riding on its operator path. ``members`` is empty
    for nodes nothing was fused into (singleton groups)."""

    host: str
    members: Tuple[str, ...] = ()

    @property
    def size(self) -> int:
        return 1 + len(self.members)


def execution_partitions(chain: Chain, report: FusionReport) -> List[ExecGroup]:
    """Partition a *fused* chain into ordered execution groups.

    Every surviving node of ``chain`` yields exactly one group, in chain
    order; ``report.groups`` supplies the absorbed members. Note that
    consumer-``pre`` fusion replicates a node into each consumer, so a
    fused-away node may legitimately appear in several groups' members
    (the paper's "FP2 can be processed as the pre of FP3 *and* FP4").
    """
    return [ExecGroup(host=name,
                      members=tuple(report.groups.get(name, ())))
            for name in chain.nodes]


def _is_fusible(g: GConv) -> bool:
    if g.reduce != "none":
        return False
    if g.out_dtype is not None:
        # the node is a quantization point: its intermediate's dtype is
        # semantic, and riding on a neighbor's operator path would drop
        # the cast (the pre/post vocabulary carries no dtype change)
        return False
    if any(d.nks > 1 or d.nop > 1 for d in g.dims):
        return False
    if g.main != "none" and g.main not in _MAIN_AS_UNARY:
        return False
    return True


def _as_unary_ops(g: GConv) -> Tuple[Op, ...]:
    """The fusible GCONV's whole computation as a pre/post op sequence."""
    ops = tuple(g.pre)
    if g.main != "none":
        ops += (Op(_MAIN_AS_UNARY[g.main], operand=g.kernel),)
    ops += tuple(g.post)
    return ops


def fuse_chain(chain: Chain) -> Tuple[Chain, FusionReport]:
    """Return a new, fused chain plus the fusion report. Pure (input chain is
    not mutated); iterates to fixpoint."""
    import copy

    chain = copy.deepcopy(chain)
    before_len = len(chain.nodes)
    fused_names: List[str] = []
    saved = 0
    order = list(chain.nodes)
    positions = {n: i for i, n in enumerate(order)}
    groups: Dict[str, List[str]] = {}

    def absorb(host: str, name: str):
        """Record that ``name`` (and anything already fused into it) now
        rides on ``host``'s operator path."""
        members = groups.get(name, [])
        groups.setdefault(host, []).append(name)
        groups[host].extend(members)

    changed = True
    while changed:
        changed = False
        consumers = chain.consumers()
        for name in list(chain.nodes):
            node = chain.nodes.get(name)
            if node is None or not isinstance(node, GConv):
                continue
            if not _is_fusible(node):
                continue
            if name in chain.outputs:
                continue
            cons = consumers.get(name, [])
            if not cons:
                continue
            # never eliminate a tensor someone consumes as kernel/operand
            used_as_input_only = all(
                isinstance(chain.nodes[c], GConv)
                and chain.nodes[c].input == name
                and chain.nodes[c].kernel != name
                and all(op.operand != name for op in
                        tuple(chain.nodes[c].pre) + tuple(chain.nodes[c].post))
                for c in cons)
            if not used_as_input_only:
                continue
            unary = _as_unary_ops(node)
            # operand tensors must already exist before the fusion target
            producer = node.input
            # --- direction 1: fuse into producer's post --------------------
            prod_node = chain.nodes.get(producer)
            if (isinstance(prod_node, GConv)
                    and consumers.get(producer, []) == [name]
                    and producer not in chain.outputs
                    and tuple(chain.shape_of(producer)) == node.out_shape
                    and all(op.operand is None
                            or positions.get(op.operand, -1)
                            < positions[producer]
                            for op in unary)):
                prod_node.post = tuple(prod_node.post) + unary
                for c in cons:
                    cn = chain.nodes[c]
                    cn.input = producer  # type: ignore[union-attr]
                del chain.nodes[name]
                chain.meta.pop(name, None)
                absorb(producer, name)
                groups.pop(name, None)
                fused_names.append(f"{name}->post({producer})")
                saved += node.out_elems
                changed = True
                break
            # --- direction 2: fuse into every consumer's pre ---------------
            ok = all(
                positions.get(op.operand, -1) < positions[c]
                for c in cons for op in unary if op.operand is not None)
            same_shape = tuple(chain.shape_of(node.input)) == node.out_shape
            if ok and same_shape:
                for c in cons:
                    cn = chain.nodes[c]
                    cn.pre = unary + tuple(cn.pre)   # type: ignore
                    cn.input = node.input            # type: ignore
                    absorb(c, name)
                del chain.nodes[name]
                chain.meta.pop(name, None)
                groups.pop(name, None)
                fused_names.append(f"{name}->pre({','.join(cons)})")
                saved += node.out_elems
                changed = True
                break
        if changed:
            consumers = chain.consumers()
    chain.validate()
    return chain, FusionReport(before_len, len(chain.nodes),
                               fused_names, saved, groups)
