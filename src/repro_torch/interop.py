"""Carry data between the JAX package and the port.

Both sides meet at numpy: ``bsm_from_arrays`` builds the port's matrix from
``np.asarray`` of each field of the reference's ``BlockSparseMatrix``, and
``bsm_to_numpy`` goes the other way; ``params_from_jax`` and
``cache_from_jax`` turn the reference LM's parameter and cache pytrees
(leaves as numpy) into the port's per-layer layout, generic over leaf
names: an MoE block's ``moe`` dict (``router`` f32; ``w_in``, ``w_gate``,
``w_out`` and the fused ``shared_*`` experts in the model dtype), a mamba
block's ``mamba`` dict, an rwkv6 block's ``rwkv`` dict and a whisper
decoder block's ``xattn`` / ``ln_x``, with whisper's ``encoder`` blocks
unstacked beside the decoder's, and the per-layer cache by mixer: ``k`` /
``v`` (and ``xk`` / ``xv``), ``conv`` / ``ssm`` or
``shift_t`` / ``shift_c`` / ``wkv``.  Every leaf keeps its dtype: the
f32 ones stay f32 (``a_log``, ``dt_bias``, ``d_skip``, ``mu_*``,
``decay_base``, ``bonus_u``, ``ln_x_w``, norms, the ``router``, and the
``ssm`` and ``wkv`` states), the others are in the model dtype.
``opt_state_from_jax`` carries the reference's AdamW state across the
same way (moments unstacked as the parameters, in their own dtype; the
step; the compression residual ``efb`` when present).  No jax import
here.

JAX's bf16 arrays come out of ``np.asarray`` as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` rejects; they cross as float32 and are cast to
``torch.bfloat16`` — exact, since every bf16 value is a float32 value.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ArchConfig, resolve_device
from repro_torch.core.bsm import BlockSparseMatrix


def _to_tensor(x, device) -> torch.Tensor:
    a = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def bsm_from_arrays(blocks, mask, norms, *, device=None) -> BlockSparseMatrix:
    """The port's matrix from the three numpy fields (bit-exact)."""
    dev = resolve_device(device)
    return BlockSparseMatrix(
        blocks=_to_tensor(blocks, dev),
        mask=_to_tensor(mask, dev).to(torch.bool),
        norms=_to_tensor(norms, dev).to(torch.float32),
    )


def bsm_to_numpy(m: BlockSparseMatrix) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(blocks, mask, norms) as numpy; bf16 blocks come back as float32
    (exact), since numpy has no bfloat16 of its own."""
    blocks = m.blocks
    if blocks.dtype == torch.bfloat16:
        blocks = blocks.to(torch.float32)
    return (blocks.cpu().numpy(), m.mask.cpu().numpy(), m.norms.cpu().numpy())


def _tree_to_tensors(tree, device, index=None):
    """Nested dicts of arrays -> nested dicts of tensors, optionally taking
    ``leaf[index]`` of every leaf (one repetition of a stacked block)."""
    if isinstance(tree, dict):
        return {k: _tree_to_tensors(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree)
    return _to_tensor(a if index is None else a[index], device)


def _unstack_blocks(n_layers: int, stacked, device) -> list:
    """The reference stacks pattern position i's blocks over the
    repetitions r and runs layer r * period + i; the port keeps one dict
    per layer, in that order."""
    period = len(stacked)
    reps = n_layers // period
    return [_tree_to_tensors(stacked[i], device, r)
            for r in range(reps) for i in range(period)]


def params_from_jax(cfg: ArchConfig, params, *, device=None) -> dict:
    """The port's parameters from the reference's ``init_params`` pytree
    (bit-exact; bf16 crosses as float32), whisper's encoder blocks
    unstacked in order."""
    dev = resolve_device(device)
    out = {
        "embed": _tree_to_tensors(params["embed"], dev),
        "blocks": _unstack_blocks(cfg.n_layers, params["blocks"], dev),
        "final_norm": _tree_to_tensors(params["final_norm"], dev),
    }
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "blocks": _unstack_blocks(cfg.encoder.n_layers, enc["blocks"],
                                      dev),
            "final_norm": _tree_to_tensors(enc["final_norm"], dev),
        }
    return out


def cache_from_jax(cfg: ArchConfig, cache, *, device=None) -> dict:
    """The port's per-layer cache (K/V rows, whisper's cross K/V and
    recurrent states) from the reference's stacked one."""
    return {"blocks": _unstack_blocks(cfg.n_layers, cache["blocks"],
                                      resolve_device(device))}


def opt_state_from_jax(cfg: ArchConfig, opt_state, *, device=None) -> dict:
    """The port's optimizer state from the reference's: ``mu`` and ``nu``
    unstacked as ``params_from_jax`` unstacks the parameters (each leaf
    in its own dtype), ``step`` as a 0-d int32 tensor and, when present,
    the f32 error-feedback residual ``efb``."""
    dev = resolve_device(device)
    out = {name: params_from_jax(cfg, opt_state[name], device=dev)
           for name in ("mu", "nu")}
    out["step"] = _to_tensor(np.asarray(opt_state["step"]), dev)
    if opt_state.get("efb") is not None:
        out["efb"] = params_from_jax(cfg, opt_state["efb"], device=dev)
    return out
