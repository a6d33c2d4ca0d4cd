"""Fusion-group partitioning for the compiled engine (paper §4.3).

Runs operation fusion over a chain and re-exposes the resulting groups as
ordered *execution partitions*: one partition per surviving node, carrying
the fused members that now ride on its pre/post operator path. The engine
emits exactly one step per partition, so the §4.3 movement savings become
real: a fused member's intermediate tensor never exists in the compiled
program — the engine sees only the host node's fused operator sequence.
"""
from __future__ import annotations

from typing import List, Tuple

from ..core.chain import Chain
from ..core.fusion import (ExecGroup, FusionReport, execution_partitions,
                           fuse_chain)


def partition_chain(chain: Chain,
                    fuse: bool = True) -> Tuple[Chain, FusionReport,
                                                List[ExecGroup]]:
    """Fuse (optionally) and partition. With ``fuse=False`` the chain is
    returned as-is with singleton partitions — the differential-testing
    configuration (compiled-unfused vs compiled-fused vs oracle)."""
    if fuse:
        fused, report = fuse_chain(chain)
    else:
        fused = chain
        report = FusionReport(len(chain.nodes), len(chain.nodes), [], 0, {})
    return fused, report, execution_partitions(fused, report)
