"""PyTorch/CUDA port of the GCONV-chain system, beside the JAX package.

``repro_torch`` runs the paper's main path on an NVIDIA H100: a zoo CNN
built as a GCONV chain (``models.cnn``), fused by §4.3 (``core.fusion``),
planned node by node and run by ``exec.compile_chain``, with the grouped
matmul and spatial convolution steps on hand-written CUDA kernels
(``kernels/csrc``). It imports torch, numpy and the standard library only;
the JAX package ``repro`` is the reference the tests hold it against.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
