"""Compiled GCONV-chain execution engine (the fast path).

Compiles a chain once — §4.3 fusion-group partitioning, per-GCONV backend
dispatch (grouped matmul / spatial conv / reductions / elementwise / the
softmax segment), Movement and Concat — and runs its steps in order.
"""
from .dispatch import dispatch_gconv, plan_chain
from .engine import CompiledChain, CompileOptions, compile_chain
from .lowering import classify_dim, dim_classes

__all__ = ["CompiledChain", "CompileOptions", "compile_chain",
           "dispatch_gconv", "plan_chain", "classify_dim", "dim_classes"]
