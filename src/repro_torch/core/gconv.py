"""GCONV: the paper's parameterized general convolution (§3.1).

A GCONV is a 1-D convolution scaled to N named dimensions. Per dimension it is
characterized by four loop parameters (``Ng``, ``Nop``, ``Nopc``, ``Nks``) plus
the auxiliary stride ``s`` and padding ``ps``:

  * the inputs are separated into ``Ng`` groups with no inter-group reuse;
  * within a group, ``Nop`` kernels are applied in parallel;
  * each kernel has ``Nks`` taps;
  * each kernel produces ``Nopc`` outputs (sliding with stride ``s``).

Four *operators* complete the definition: ``pre`` (input preprocess), ``main``
(input ⊗ kernel-parameter), ``reduce`` (partial-result reduction over the
``Nks`` taps) and ``post`` (output postprocess). ``main`` is not restricted to
multiply nor ``reduce`` to add — that generality is what lets every CNN/LM layer
be expressed as a GCONV (paper Table 2).

Shape conventions (matching the paper's Figure 5 reading of a conv layer):
  input axis size per dim   = Ng * Nips,  Nips = (Nopc-1)*s + Nks - 2*ps
  kernel axis size per dim  = Ng * Nop * Nks   (or 1 => broadcast)
  output axis size per dim  = Ng * Nop * Nopc

Note: the paper's Eq. (1) prints ``(Nopc+1)*s``; the dimensionally consistent
relation used in all of the paper's own examples is ``(Nopc-1)*s`` — see
DESIGN.md §1 (erratum).

A copy of the JAX package's ``repro.core.gconv``: the IR is framework-free and
identical in both packages, so chains, parameter names and shapes agree
(``tests/test_torch_ir.py`` holds the copy to its original).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

DEFAULTS = dict(ng=1, nop=1, nopc=1, nks=1, stride=1, pad=0)


@dataclass(frozen=True)
class DimSpec:
    """The four GCONV loop parameters (+ stride/pad) of one dimension.

    ``pad`` is the left padding; ``pad_r`` the right padding (``None`` means
    symmetric, = ``pad``). ``pad_r`` may exceed ``pad`` (Caffe ceil-mode
    pooling) or be negative (trailing input elements the sliding window never
    reads — floor-mode with inexact geometry). The paper's Eq. (1) assumes the
    exact symmetric case; this is the natural generalization.
    """

    name: str
    ng: int = 1
    nop: int = 1
    nopc: int = 1
    nks: int = 1
    stride: int = 1
    pad: int = 0
    pad_r: Optional[int] = None

    def __post_init__(self):
        for f in ("ng", "nop", "nopc", "nks", "stride"):
            v = getattr(self, f)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"DimSpec {self.name}: {f}={v} must be int >= 1")
        if self.pad < 0:
            raise ValueError(f"DimSpec {self.name}: pad={self.pad} must be >= 0")
        if self.nips < 1:
            raise ValueError(
                f"DimSpec {self.name}: derived Nips={self.nips} < 1 "
                f"(nopc={self.nopc}, s={self.stride}, nks={self.nks}, ps={self.pad})"
            )
        if self.nips + min(self.padr, 0) < 1:
            raise ValueError(f"DimSpec {self.name}: crop exceeds input")

    # ---- derived sizes (paper Eq. (1), corrected) ----
    @property
    def padr(self) -> int:
        return self.pad if self.pad_r is None else self.pad_r

    @property
    def nips(self) -> int:
        return (self.nopc - 1) * self.stride + self.nks - self.pad - self.padr

    @property
    def in_size(self) -> int:
        return self.ng * self.nips

    @property
    def k_size(self) -> int:
        return self.ng * self.nop * self.nks

    @property
    def out_size(self) -> int:
        return self.ng * self.nop * self.nopc

    @property
    def is_default(self) -> bool:
        """True if this dim carries no effectual loop (paper: prunable)."""
        return (self.ng, self.nop, self.nopc, self.nks) == (1, 1, 1, 1)

    @property
    def has_overlap_reuse(self) -> bool:
        """Paper §3.1: inputs are overlap-reused by outputs when Nks > s."""
        return self.nks > self.stride and self.nopc > 1

    def effectual_loops(self) -> Tuple[Tuple[str, int], ...]:
        out = []
        for p in ("ks", "opc", "op", "g"):
            n = {"ks": self.nks, "opc": self.nopc, "op": self.nop, "g": self.ng}[p]
            if n > 1:
                out.append((p, n))
        return tuple(out)

    def pretty(self) -> str:
        parts = []
        for label, attr in (("Ng", "ng"), ("Nop", "nop"), ("Nks", "nks"),
                            ("Nopc", "nopc"), ("s", "stride"), ("ps", "pad")):
            v = getattr(self, attr)
            if v != DEFAULTS[attr if attr != "stride" else "stride"]:
                parts.append(f"{label}:{v}")
        return f"{self.name}[{', '.join(parts) or 'default'}]"


@dataclass(frozen=True)
class Op:
    """One pre/post operator application.

    ``const``   — scalar parameter (e.g. scale factor, epsilon).
    ``operand`` — optional reference (chain node / param name) to a tensor used
                  as the second argument; after operation fusion (paper §4.3)
                  pre/post operators "may have more than one parameter" — this
                  is how fused kernel parameters are carried.
    """

    name: str
    const: Optional[float] = None
    operand: Optional[str] = None

    def pretty(self) -> str:
        s = self.name
        if self.const is not None:
            s += f"({self.const:g})"
        if self.operand is not None:
            s += f"[{self.operand}]"
        return s


@dataclass
class GConv:
    """One GCONV operation in a chain (paper Fig. 3/4 scaled to N dims)."""

    name: str
    dims: Tuple[DimSpec, ...]
    input: str                              # producer node or external input name
    kernel: Optional[str] = None            # producer node / parameter name / None
    pre: Tuple[Op, ...] = ()
    main: str = "mul"                       # "none" => no kernel parameter
    reduce: str = "add"                     # "none" => no reduction (all nks==1)
    post: Tuple[Op, ...] = ()
    out_dtype: Optional[str] = None         # None => same as input

    def __post_init__(self):
        names = [d.name for d in self.dims]
        if len(set(names)) != len(names):
            raise ValueError(f"GCONV {self.name}: duplicate dim names {names}")
        if self.main == "none" and self.kernel is not None:
            raise ValueError(f"GCONV {self.name}: main='none' but kernel given")
        if self.main != "none" and self.kernel is None:
            raise ValueError(f"GCONV {self.name}: main={self.main!r} needs a kernel")
        has_taps = any(d.nks > 1 for d in self.dims)
        if has_taps and self.reduce == "none":
            raise ValueError(
                f"GCONV {self.name}: Nks>1 in some dim but reduce='none'")

    # ---- shapes ----
    @property
    def in_shape(self) -> Tuple[int, ...]:
        return tuple(d.in_size for d in self.dims)

    @property
    def k_shape(self) -> Tuple[int, ...]:
        return tuple(d.k_size for d in self.dims)

    @property
    def out_shape(self) -> Tuple[int, ...]:
        return tuple(d.out_size for d in self.dims)

    def dim(self, name: str) -> DimSpec:
        for d in self.dims:
            if d.name == name:
                return d
        raise KeyError(name)

    def with_dims(self, dims: Sequence[DimSpec]) -> "GConv":
        return dataclasses.replace(self, dims=tuple(dims))

    # ---- workload statistics (used by cost model & Table-1 benchmark) ----
    @property
    def macs(self) -> int:
        """Main-op applications (the paper's 'computation')."""
        n = 1
        for d in self.dims:
            n *= d.ng * d.nop * d.nopc * d.nks
        return n

    @property
    def out_elems(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.out_size
        return n

    @property
    def in_elems(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.in_size
        return n

    @property
    def k_elems(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.k_size
        return n

    @property
    def is_mxu_eligible(self) -> bool:
        """mul/add GCONVs map to the MXU (TPU adaptation; DESIGN.md §2)."""
        return self.main == "mul" and self.reduce == "add"

    def pretty(self) -> str:
        dims = " ".join(d.pretty() for d in self.dims if not d.is_default)
        ops = []
        if self.pre:
            ops.append("pre=" + ",".join(o.pretty() for o in self.pre))
        ops.append(f"main={self.main}")
        ops.append(f"reduce={self.reduce}")
        if self.post:
            ops.append("post=" + ",".join(o.pretty() for o in self.post))
        k = f" k={self.kernel}" if self.kernel else ""
        return (f"{self.name}: <{dims or 'scalar'}> in={self.input}{k} "
                f"[{' '.join(ops)}] -> {self.out_shape}")


def dims_from_shape(names: Sequence[str], shape: Sequence[int],
                    **overrides) -> Tuple[DimSpec, ...]:
    """Helper: elementwise-style dims (Ng=size) unless overridden per name."""
    out = []
    for n, s in zip(names, shape):
        kw = overrides.get(n, {"ng": s})
        out.append(DimSpec(name=n, **kw))
    return tuple(out)
