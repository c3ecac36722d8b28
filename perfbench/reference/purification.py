"""Plain reference of the purification: the density matrix of H at the
chemical potential mu, P = sum over eigenvalues below mu of v v^T, from a
dense float64 ``eigh``.  Imports nothing of the program.

The control (``newton_schulz``) is the sign iteration the program runs,
X <- X (3 I - X^2) / 2 from X0 = (H - mu I) / ||H - mu I||_F until the
relative change falls under ``tol``, on the dense matrix with plain
matrix products, in a chosen precision (TF32 for the control of f32).
"""
from __future__ import annotations

import torch


def dense(blocks: torch.Tensor, mask: torch.Tensor,
          dtype=torch.float64) -> torch.Tensor:
    """The dense matrix of a block grid (nb_r, nb_c, bs_r, bs_c) and its
    mask: blocks outside the mask are zero."""
    nb_r, nb_c, bs_r, bs_c = blocks.shape
    m = blocks.to(dtype) * mask[:, :, None, None].to(dtype)
    return m.permute(0, 2, 1, 3).reshape(nb_r * bs_r, nb_c * bs_c)


def density_matrix(h: torch.Tensor, mu: float) -> tuple[torch.Tensor, int]:
    """(P, number of eigenvalues below mu) of the symmetric ``h``, in
    float64."""
    h = h.to(torch.float64)
    w, v = torch.linalg.eigh(h)
    occ = w < mu
    vo = v[:, occ]
    return vo @ vo.T, int(occ.sum())


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits, to nearest,
    ties away): what the tensor cores read of an f32 operand."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """a @ b; with ``tf32`` the operands are read as TF32 (the CUDA
    tensor cores do that themselves; on the CPU they are rounded here),
    the sum kept in f32."""
    if tf32 and a.device.type != "cuda":
        return to_tf32(a) @ to_tf32(b)
    return a @ b


def newton_schulz(h: torch.Tensor, mu: float, *, tol: float, max_iter: int,
                  dtype=torch.float32, tf32: bool = False) -> torch.Tensor:
    """P = (I - sign(H - mu I)) / 2 by the Newton-Schulz sign iteration on
    the dense matrix, in ``dtype``, with TF32 products when ``tf32``."""
    n = h.shape[0]
    eye = torch.eye(n, dtype=dtype, device=h.device)
    x = h.to(dtype) - mu * eye
    x = x / torch.linalg.norm(x)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for _ in range(max_iter):
            xn = 0.5 * _matmul(x, 3.0 * eye - _matmul(x, x, tf32), tf32)
            change = torch.linalg.norm(xn - x) / torch.linalg.norm(xn)
            x = xn
            if float(change) < tol:
                break
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return 0.5 * (eye - x)


def max_abs_error(p: torch.Tensor, p_ref: torch.Tensor,
                  rows: int = 2048) -> float:
    """max |P - P_ref|, in float64, over row blocks of ``rows``."""
    worst = 0.0
    for r0 in range(0, p.shape[0], rows):
        d = p[r0:r0 + rows].to(torch.float64) - p_ref[r0:r0 + rows]
        worst = max(worst, float(d.abs().max()))
    return worst
