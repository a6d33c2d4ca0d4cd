"""The compiled GCONV-chain execution engine.

The counterpart of the JAX package's ``repro.exec.engine`` in exact-shape
mode. ``compile_chain`` turns a :class:`~repro_torch.core.chain.Chain` into
a :class:`CompiledChain`: §4.3 fusion partitions the chain into fusion
groups (``exec.partition``), each group is dispatched to its backend
(``exec.dispatch`` / ``exec.lowering``) and the steps run in chain order.

Steps run eagerly, one PyTorch call sequence per step on the current
stream: there is no ``jit`` to fuse the program, and a CUDA graph over the
chain is later work. Movement and Concat steps are views and copies.

Usage::

    eng = compile_chain(chain)                 # the card; device="cpu" too
    params = eng.init_params(torch.Generator("cuda").manual_seed(0))
    outs = eng(inputs, params)                 # dict of chain outputs
    eng.dispatch                               # node -> backend table
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..convert import DeviceLike, resolve_device
from ..core.chain import Chain
from ..core.fusion import ExecGroup, FusionReport
from ..kernels.common import MXU_MIN
from .dispatch import Plan, plan_chain
from .partition import partition_chain


@dataclass(frozen=True)
class CompileOptions:
    fuse: bool = True            # run §4.3 operation fusion first
    segments: bool = True        # recognize the softmax segment
    backend: str = "auto"        # auto | torch | cuda
    mxu_min: int = MXU_MIN       # min K/N to prefer the CUDA matmul (auto)


class CompiledChain:
    """A chain planned into steps on one device (plus introspection)."""

    def __init__(self, source: Chain, chain: Chain, report: FusionReport,
                 partitions: List[ExecGroup], plan: Plan,
                 options: CompileOptions, device: torch.device):
        self.source = source
        self.chain = chain                   # the fused chain actually run
        self.fusion_report = report
        self.partitions = partitions
        self._plan = plan
        self.steps = plan.steps
        self.dispatch: Dict[str, str] = plan.dispatch
        self.options = options
        self.device = device

    def init_params(self, generator: torch.Generator,
                    scale: float = 0.1) -> Dict[str, torch.Tensor]:
        """``scale * N(0, 1)`` parameters from ``generator``, on the
        generator's device."""
        from ..core.interpreter import init_chain_params
        return init_chain_params(self.chain, generator, scale)

    def _operands(self, given: Mapping[str, object], want, what: str
                  ) -> Dict[str, torch.Tensor]:
        out = {}
        for name, info in want.items():
            if name not in given:
                raise ValueError(f"missing chain {what} {name!r}")
            t = given[name]
            if not isinstance(t, torch.Tensor):   # a copy: arrays may be
                t = torch.from_numpy(np.array(t))  # read-only
            t = t.to(self.device)
            if tuple(t.shape) != info.shape:
                raise ValueError(f"{what} {name!r}: got {tuple(t.shape)}, "
                                 f"want {info.shape}")
            out[name] = t
        return out

    def __call__(self,
                 inputs: Mapping[str, torch.Tensor],
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 keep_all: bool = False) -> Dict[str, torch.Tensor]:
        """Run the chain on exact-shape ``inputs`` and ``params`` (tensors
        or arrays, moved to the engine's device). Returns the chain outputs;
        ``keep_all=True`` returns the whole environment — inputs, params and
        every produced node — except the §4.3-fused members and segment
        interiors, which the compiled program never materializes (see the
        ``fused:`` tags in ``dispatch``)."""
        env = self._operands(inputs, self.chain.inputs, "input")
        env.update(self._operands(params or {}, self.chain.params, "param"))
        with torch.inference_mode():
            for step in self.steps:
                env[step.name] = step.run(env)
        if keep_all:
            return env
        outs = self.chain.outputs or [list(self.chain.nodes)[-1]]
        return {o: env[o] for o in outs}

    @property
    def signature(self) -> str:
        """Stable program identity: chain name + input shapes + dispatch
        decisions."""
        return self._plan.signature

    def backend_histogram(self) -> Dict[str, int]:
        hist: Dict[str, int] = {}
        for tag in self.dispatch.values():
            key = tag.split(":")[0] if tag.startswith("fused") else tag
            hist[key] = hist.get(key, 0) + 1
        return hist

    def pretty(self) -> str:
        lines = [f"CompiledChain {self.chain.name!r} on {self.device}: "
                 f"{len(self.steps)} steps from {len(self.source.nodes)} "
                 f"nodes (fusion {self.fusion_report.before_len}->"
                 f"{self.fusion_report.after_len})"]
        for name, tag in self.dispatch.items():
            lines.append(f"  {name}: {tag}")
        return "\n".join(lines)


def compile_chain(chain: Chain, device: DeviceLike = None,
                  **options) -> CompiledChain:
    """Compile a chain for ``device`` (``None``: the card; raises when
    CUDA is absent — pass ``device="cpu"`` for the CPU). See
    :class:`CompileOptions` for ``options``. Under ``backend="auto"`` the
    plan for a CUDA device runs the hand-written kernels where the
    reference's gates allow, and the plan for the CPU runs none."""
    dev = resolve_device(device)
    opts = CompileOptions(**options)
    chain.validate()
    fused, report, parts = partition_chain(chain, fuse=opts.fuse)
    plan = plan_chain(fused, backend=opts.backend, mxu_min=opts.mxu_min,
                      segments=opts.segments, device_type=dev.type)
    # §4.3-fused nodes no longer exist in the fused chain; record them in
    # the dispatch table so every ORIGINAL node has an entry
    for host, members in report.groups.items():
        for m in members:
            plan.dispatch.setdefault(m, f"fused:{host}")
    return CompiledChain(chain, fused, report, parts, plan, opts, dev)
