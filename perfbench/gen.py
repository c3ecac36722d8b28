"""Inputs made from the seed: the Hamiltonian's blocks and the model's
weights.  The same seed gives the same inputs on the same kind of device.

Both are made on the device, in a few large calls, in the dtype they are
used in: the program and the reference are handed the same tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def decay_mask(seed: int, nb: int, occupancy: float) -> np.ndarray:
    """(nb, nb) bool: occupation probability exp(-|i - j| / s) with s =
    occupancy nb / 2 (the mean probability is then about ``occupancy``),
    the diagonal always occupied, then symmetrised: the pattern of
    linear-scaling DFT operators.  A frozen copy of the decay pattern of
    the program's ``bsm.random_bsm``."""
    rng = np.random.default_rng(seed)
    d = np.abs(np.arange(nb)[:, None] - np.arange(nb)[None, :])
    scale = max(occupancy * nb / 2.0, 1e-3)
    m = rng.random((nb, nb)) < np.exp(-d / scale)
    m[np.arange(nb), np.arange(nb)] = True
    return m | m.T


def base_hamiltonian(pattern_seed: int, nb: int, bs: int, occupancy: float,
                     device) -> tuple[torch.Tensor, torch.Tensor]:
    """(blocks (nb, nb, bs, bs) f32, mask (nb, nb) bool) of a symmetric
    block-sparse H0: N(0, 1 / bs) entries, symmetrised, zero outside the
    decay mask, both drawn from ``pattern_seed``."""
    mask = torch.from_numpy(decay_mask(pattern_seed, nb, occupancy)).to(device)
    gen = torch.Generator(device=device).manual_seed(pattern_seed)
    blocks = torch.randn((nb, nb, bs, bs), generator=gen, device=device)
    blocks = blocks / np.sqrt(bs)
    blocks = 0.5 * (blocks + blocks.permute(1, 0, 3, 2))
    return blocks * mask[:, :, None, None], mask


def block_rotations(seed: int, nb: int, bs: int, device) -> torch.Tensor:
    """(nb, bs, bs) float64: a random orthogonal matrix per block row
    (Haar, from the QR of a normal draw with R's diagonal made positive),
    drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((nb, bs, bs), generator=gen, device=device,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]


def hamiltonian(seed: int, nb: int, bs: int, occupancy: float, device, *,
                pattern_seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(blocks f32, mask) of H = Q H0 Q^T, with H0 from ``pattern_seed`` and
    Q block-diagonal orthogonal from ``seed``: block (i, j) is Q_i H0_ij
    Q_j^T.  Every seed gets the same mask, block norms and spectrum, so
    the same sweeps, fill-in and kept products, in another basis; its P
    is Q P0 Q^T."""
    blocks, mask = base_hamiltonian(pattern_seed, nb, bs, occupancy, device)
    q = block_rotations(seed, nb, bs, device)
    out = torch.empty_like(blocks)
    for i in range(nb):  # one block row at a time, in float64
        row = q[i] @ blocks[i].to(torch.float64) @ q.transpose(-1, -2)
        out[i] = row.to(torch.float32)
    return out * mask[:, :, None, None], mask


# ---------------------------------------------------------------------------
# MoE decoder weights, in the program's parameter layout
# ---------------------------------------------------------------------------


def lm_leaves(cfg: dict) -> list[tuple[tuple, tuple, float, str]]:
    """(path, shape, scale, kind) of every weight; kind ``mat`` is drawn
    N(0, 1) * scale in the model dtype, ``router`` the same in f32, and
    ``norm`` is zero (an RMSNorm scales by 1 + w)."""
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    e, de = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    ds = de * cfg["n_shared_experts"]
    v = cfg["vocab_size"]
    out = [(("embed", "tok"), (v, d), 0.02, "mat"),
           (("embed", "out"), (v, d), d ** -0.5, "mat"),
           (("final_norm", "w"), (d,), 0.0, "norm")]
    for layer in range(cfg["num_hidden_layers"]):
        b = ("blocks", layer)
        out += [
            (b + ("ln1", "w"), (d,), 0.0, "norm"),
            (b + ("attn", "wq"), (d, h * hd), d ** -0.5, "mat"),
            (b + ("attn", "wk"), (d, hkv * hd), d ** -0.5, "mat"),
            (b + ("attn", "wv"), (d, hkv * hd), d ** -0.5, "mat"),
            (b + ("attn", "wo"), (h * hd, d), (h * hd) ** -0.5, "mat"),
            (b + ("ln2", "w"), (d,), 0.0, "norm"),
            (b + ("moe", "router"), (d, e), d ** -0.5, "router"),
            (b + ("moe", "w_in"), (e, d, de), d ** -0.5, "mat"),
            (b + ("moe", "w_gate"), (e, d, de), d ** -0.5, "mat"),
            (b + ("moe", "w_out"), (e, de, d), de ** -0.5, "mat"),
            (b + ("moe", "shared_in"), (d, ds), d ** -0.5, "mat"),
            (b + ("moe", "shared_gate"), (d, ds), d ** -0.5, "mat"),
            (b + ("moe", "shared_out"), (ds, d), de ** -0.5, "mat"),
        ]
    return out


def _put(tree: dict, path: tuple, value) -> None:
    """Set ``tree[path[0]][path[1]]...`` to ``value``; an int key indexes
    a list (the layers), grown as needed."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def lm_params(cfg: dict, seed: int, device) -> dict:
    """The weights of the configuration, drawn from ``seed`` on
    ``device``: one normal draw for all matrices in the model dtype and
    one in f32 for the routers, each leaf a scaled view of its buffer."""
    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[cfg["torch_dtype"]]
    leaves = lm_leaves(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    bufs = {}
    for kind, dt in (("mat", dtype), ("router", torch.float32)):
        n = sum(int(np.prod(s)) for _, s, _, k in leaves if k == kind)
        bufs[kind] = torch.empty(n, dtype=dt, device=device).normal_(
            generator=gen)
    offs = {"mat": 0, "router": 0}
    params: dict = {}
    for path, shape, scale, kind in leaves:
        if kind == "norm":
            t = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            n = int(np.prod(shape))
            t = bufs[kind][offs[kind]:offs[kind] + n].view(shape)
            t.mul_(scale)
            offs[kind] += n
        _put(params, path, t)
    return params
