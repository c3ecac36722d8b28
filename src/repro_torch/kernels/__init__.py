"""Hand-written Hopper kernels of the port, with their plain twins.

block_spgemm — DBCSR's filtered batched block GEMM (the paper's hot spot),
CUDA C++ in ``csrc/block_spgemm.cu``.
flash_attention — online-softmax attention (causal, window, softcap, GQA),
CUDA C++ in ``csrc/flash_attention.cu``; its backward (dQ, dK, dV from the
forward's row log-sum-exp) in ``csrc/flash_attention_bwd.cu``, behind the
``FlashAttention`` autograd Function.

Each kernel has a plain-torch oracle in ref.py and a public wrapper in
ops.py.  Kernels are built at first use on a CUDA tensor, never at import.
"""
