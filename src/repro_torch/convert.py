"""Devices and operands for the port.

:func:`resolve_device` is the one place an entry point turns its
``device`` argument into a :class:`torch.device`: ``None`` means the card.
:func:`params_from_numpy` / :func:`inputs_from_numpy` carry numpy operands —
for example the JAX package's parameters, ``np.asarray`` of its
``init_chain_params`` output — into the port. Names and shapes carry over
unchanged because both packages build the same chain IR.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent.

    For a CUDA device this turns TF32 off for matmuls and for cuDNN,
    process-wide (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` set to False): cuDNN runs f32
    convolutions in TF32 by default, about three decimal digits, far
    outside the reference's ``rtol=1e-4``, and the ``conv:torch`` steps go
    through cuDNN."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {dev}")
    return dev


def _to_tensors(arrays: Mapping[str, object],
                device: DeviceLike) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    # np.array copies: a read-only buffer (e.g. np.asarray of a jax.Array)
    # is not handed to torch, which would warn and may not write to it
    return {name: torch.from_numpy(np.array(a, copy=True)).to(dev)
            for name, a in arrays.items()}


def params_from_numpy(params: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Chain parameters as tensors on ``device`` (dtype kept)."""
    return _to_tensors(params, device)


def inputs_from_numpy(inputs: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Chain inputs as tensors on ``device`` (dtype kept)."""
    return _to_tensors(inputs, device)
