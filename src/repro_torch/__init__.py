"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The module tree mirrors ``repro`` file for file.  The port imports torch
and numpy only: never jax, and nothing of the JAX package, which stays the
reference every module here is tested against.

Slice 1: the single-device main path of the paper's workload —
``core.bsm.random_bsm`` -> ``core.engine.multiply`` ->
``core.signiter.density_matrix`` -> ``core.signiter.trace`` — with the
compacted-list block GEMM as a hand-written CUDA kernel
(``kernels/csrc/block_spgemm.cu``).

Slice 2: the serving path of the LM stack for dense attention decoders —
``launch.serve`` -> ``serving.engine.ServingEngine`` ->
``models.transformer.prefill`` / ``decode_step`` — with prefill attention
as a hand-written CUDA flash kernel (``kernels/csrc/flash_attention.cu``).
"""

__version__ = "0.1.0"
