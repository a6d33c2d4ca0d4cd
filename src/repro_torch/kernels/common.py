"""Shared kernel utilities: tile helpers and the dispatch gates.

The counterpart of the JAX package's ``repro.kernels.common`` without its
interpret-mode switch: a wrapper in this package takes its plain PyTorch
version only for a tensor that lies on the CPU, and on a CUDA tensor
launches its kernel or raises.
"""
from __future__ import annotations

# Dispatch gates of ``backend="auto"`` on the card, the reference's own
# values (``_prefer_pallas_matmul``): a grouped matmul goes to the
# ``gconv_matmul`` kernel when M >= M_ALIGN and K, N >= MXU_MIN. They keep
# the port's plan step for step equal to the reference's, so the card runs
# the kernels on the same steps the TPU does.
M_ALIGN = 8
MXU_MIN = 128


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def pick_block(n: int, target: int, align: int) -> int:
    """Aligned block size for an axis of length ``n``.

    Contract: the result ``b`` satisfies ``1 <= b <= round_up(n, align)``
    and, for ``n > align``, ``b % align == 0``. A block may be *smaller*
    than ``n`` (it never silently covers the remainder): the kernel masks
    the tail of a grid of ``cdiv(n, b)`` blocks.
    """
    if n <= align:
        return max(1, min(n, target))
    b = min(target, round_up(n, align))
    b = (b // align) * align
    return max(align, b)


def block_contract_ok(n: int, b: int, align: int) -> bool:
    """Audit form of the :func:`pick_block` contract above — ``True`` iff
    ``1 <= b <= round_up(n, align)`` and, for ``n > align``,
    ``b % align == 0``."""
    if not 1 <= b <= round_up(n, align):
        return False
    if n > align and b % align != 0:
        return False
    return True
