"""How far bf16 rwkv6-7b lands from its own f32 twin, in the JAX package
and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/rwkv_bf16_distance.py \
        [--layers 1] [--seq 256]

rwkv6-7b at full width (d 4,096, 64 heads of 64, d_ff 14,336, vocab
65,536) cut to its first ``--layers`` layers; the JAX package draws the
bf16 parameters from key 0 and the port gets them bit for bit
(``interop.params_from_jax``); each package's f32 twin is the same
weights in f32.  One forward over ``--seq`` tokens from
``np.random.default_rng(0)``, logits at every position.  Prints one JSON
line: each distance as the largest |difference| over the largest |logit|
of the second operand, and the share of equal greedy tokens, for the
reference's bf16 against its f32, the port's bf16 against its f32, the
port's bf16 against the reference's bf16 and the port's f32 against the
reference's f32.  The JAX side holds about 6 GiB at one layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _upcast_(tree) -> None:
    """Every floating leaf of nested dicts / lists in f32, in place."""
    for k, v in list(tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
        if isinstance(v, (dict, list)):
            _upcast_(v)
        elif v.is_floating_point():
            tree[k] = v.float()


def _distance(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _greedy(a: np.ndarray, b: np.ndarray) -> float:
    return float((a.argmax(-1) == b.argmax(-1)).mean())


def distances(layers: int = 1, seq: int = 256) -> dict:
    """The figures the module docstring names, as a dict."""
    jcfg = dataclasses.replace(jget_arch("rwkv6-7b"), n_layers=layers)
    cfg = dataclasses.replace(get_arch("rwkv6-7b"), n_layers=layers)
    assert jcfg.dtype == cfg.dtype == "bfloat16"
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, seq))

    def ref_logits(c, p):
        x, _ = JT.forward(c, p, jnp.asarray(toks))
        return np.asarray(JL.logits_matmul(c, p["embed"], x), np.float32)

    def port_logits(c, p):
        with torch.no_grad():
            x, _ = T.forward(c, p, torch.from_numpy(toks))
            return L.logits_matmul(c, p["embed"], x).float().numpy()

    f32 = dataclasses.replace(jcfg, dtype="float32")
    jp = JT.init_params(jcfg, jax.random.key(0))
    ref16 = ref_logits(jcfg, jp)
    up = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if jnp.issubdtype(a.dtype, jnp.floating) else a, jp)
    ref32 = ref_logits(f32, up)
    del up
    params = interop.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    del jp
    gc.collect()
    port16 = port_logits(cfg, params)
    _upcast_(params)
    port32 = port_logits(dataclasses.replace(cfg, dtype="float32"), params)
    return dict(
        layers=layers, seq=seq,
        ref_bf16_vs_f32=_distance(ref16, ref32),
        port_bf16_vs_f32=_distance(port16, port32),
        port_vs_ref_bf16=_distance(port16, ref16),
        port_vs_ref_f32=_distance(port32, ref32),
        greedy_ref_bf16_vs_f32=_greedy(ref16, ref32),
        greedy_port_bf16_vs_f32=_greedy(port16, port32),
        greedy_port_vs_ref_bf16=_greedy(port16, ref16),
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    print(json.dumps(distances(args.layers, args.seq)))


if __name__ == "__main__":
    main()
