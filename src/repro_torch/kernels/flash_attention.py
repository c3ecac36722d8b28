"""Hopper kernel: flash attention (online softmax, causal / window / softcap).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
_flash_kernel`` (launched there by ``flash_attention_single``, vmapped over
batch and heads by ``repro/kernels/ops.py::flash_attention``).  The kernels
are CUDA C++ for ``sm_90a`` in ``csrc/flash_attention.cu``, built by
``nvcc`` at first use (``kernels/_build.py``) and bound with ``ctypes``.

The TPU kernel carries its running max, sum and accumulator in VMEM across
a sequential kv grid axis; CUDA blocks run in no order, so one CTA owns a
(batch, head, q tile), walks the kv tiles that hold a kept key itself with
that state in registers, and writes its rows once.  Grouped-query heads
read their kv head as ``h // (h // hkv)``: no repeated K/V is
materialised.  Any sequence lengths: ragged tile edges are masked in the
kernel (the TPU kernel asserted divisible lengths; the JAX model pads).

What bounds it on the H100: operations (about 4 d per kept (q, k) pair,
hundreds of operations per byte moved).  bf16 inputs run on the tensor
cores: ``wgmma`` for both products (P from registers), K/V tiles through a
two-stage TMA ring.  f32 inputs run a SIMT kernel of f32 FMAs (TF32 would
break the 1e-4 parity with the reference).  The ``.cu`` file's note says
more.  TMA needs a bf16 view with a 16-byte-aligned base and (batch, head,
seq) strides that are multiples of 8 elements; the wrapper copies a view
that has neither into a fresh contiguous tensor and counts it in
``copies`` (the projections' head-transposed views need no copy).

Beside the kernel, in this module: ``flash_attention_plain``, the same
function in plain PyTorch — the online-softmax loop of the JAX model's
``chunked_attention`` in f32, over (q chunk, kv chunk) tiles.  The two
differ in one rounding: the kernel, like the TPU kernel, rounds p to v's
dtype before P.V, the plain loop keeps p in f32 (equal at f32, about 1e-2
apart at bf16).  Both give p = 0 to masked logits, so a row that keeps no
key gives zeros, as ``ref.attention_ref`` does.  ``flash_attention`` runs
the plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.  ``launches`` counts kernel launches, and nothing
else.

Training.  The TPU package has no backward kernel: its training
differentiates the jnp loop.  Here ``FlashAttention`` (an
``autograd.Function``) carries the gradient: its forward also returns each
row's log-sum-exp (``lse``, f32 (b, h, sq), +inf for a row that keeps no
key), and its backward runs the backward kernels of
``csrc/flash_attention_bwd.cu`` (delta, then dK / dV, then dQ: three
launches, counted in ``bwd_launches``) on CUDA tensors, or
``flash_attention_backward_plain``, the same algorithm in f32 chunked
loops, on CPU tensors.  Both recompute P = exp(x - lse) in f32, so the
backward is the gradient of the f32 function the plain forward computes;
at bf16 the kernel's forward rounds p for P.V, so its output sits within
the forward tolerance above.  The bf16 backward runs on the tensor cores
(``wgmma`` + TMA, like the forward); its P and dS enter the dV, dK and dQ
products as two bf16 terms each (hi + lo, about 2^-16 relative), since one
bf16 rounding of them would not hold the plain backward's limit.  The f32
backward is a SIMT kernel.  ``flash_attention``
goes through the Function only when grad is enabled and an input requires
it; otherwise it takes the forward path above unchanged (serving).
"""
from __future__ import annotations

import ctypes

import torch

launches = 0  # kernel launches since the last reset (a plain counter)
bwd_launches = 0  # backward kernel launches (BWD_KERNELS per backward)
copies = 0  # bf16 inputs copied to meet TMA's alignment (a plain counter)

BWD_KERNELS = 3  # delta, dK / dV, dQ
BWD_DELTA, BWD_DKDV, BWD_DQ = 1, 2, 4  # ``backward_launcher``'s parts
BWD_ALL = BWD_DELTA | BWD_DKDV | BWD_DQ
BWD_TILE = 64  # query rows of the bf16 dK / dV kernel's ring tiles

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)  # head dims the kernel is instantiated for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (b, h, s, d), got {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[1] != 0:
        raise ValueError(f"kv heads {k.shape[1]} do not divide heads {h}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, "
                         f"{v.device}")


def _keep_mask(qpos, kpos, skv, causal, window):
    keep = (kpos < skv)[None, :].expand(qpos.shape[0], -1)
    if causal:
        keep = keep & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        keep = keep & (kpos[None, :] > qpos[:, None] - window)
    return keep


def flash_attention_plain(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, hkv, skv, d)
    v: torch.Tensor,  # (b, hkv, skv, d)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax chunked attention in f32, the kernel's function.

    The JAX model zero-pads ragged lengths up to the chunk and masks the
    padded keys; slicing the ragged last chunk gives the same result.
    GQA groups the query heads over their kv head (no repeat).  Full f32
    on CUDA needs TF32 off (``torch.backends.cuda.matmul.allow_tf32``
    False, PyTorch's default).
    """
    return flash_attention_plain_lse(
        q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
        q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset)[0]


def flash_attention_plain_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_plain``'s loop, which also returns each row's
    log-sum-exp m + log(l) of the scaled (and capped) logits: f32 (b, h,
    sq), +inf for a row that keeps no key."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = d**-0.5
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    dev = q.device
    qg = q.reshape(b, hkv, g, sq, d)
    out = torch.empty((b, hkv, g, sq, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, hkv, g, sq), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, q_chunk):
        qi = qg[:, :, :, q0:q0 + q_chunk].float()
        cq = qi.shape[3]
        qpos = q0 + q_offset + torch.arange(cq, device=dev)
        m = torch.full((b, hkv, g, cq, 1), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, cq, 1), device=dev)
        acc = torch.zeros((b, hkv, g, cq, d), device=dev)
        for k0 in range(0, skv, kv_chunk):
            ki = k[:, :, None, k0:k0 + kv_chunk].float()
            vi = v[:, :, None, k0:k0 + kv_chunk].float()
            s = torch.matmul(qi, ki.transpose(-1, -2)) * scale
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            kpos = k0 + torch.arange(ki.shape[3], device=dev)
            keep = _keep_mask(qpos, kpos, skv, causal, window)
            s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(keep, torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.matmul(p, vi)
            m = m_new
        safe = torch.where(l == 0.0, 1.0, l)
        out[:, :, :, q0:q0 + cq] = (acc / safe).to(q.dtype)
        lse[:, :, :, q0:q0 + cq] = torch.where(
            l == 0.0, float("inf"), m + torch.log(safe))[..., 0]
    return out.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def flash_attention_backward_plain(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, hkv, skv, d)
    v: torch.Tensor,  # (b, hkv, skv, d)
    out: torch.Tensor,  # (b, h, sq, d), the forward's output
    lse: torch.Tensor,  # (b, h, sq) f32, the forward's log-sum-exp
    dout: torch.Tensor,  # (b, h, sq, d)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype: the backward kernels' algorithm
    in f32 chunked loops.  D = rowsum(dout * out); per (q chunk, kv chunk)
    P = exp(x - lse) (0 where masked), dV += P^T dO, dS = P (dO V^T - D)
    times scale (and 1 - tanh^2 under the cap), dQ += dS K, dK += dS^T Q;
    the g query heads of a kv head add into its dK / dV."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = d**-0.5
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    dev = q.device
    qg = q.reshape(b, hkv, g, sq, d)
    dog = dout.reshape(b, hkv, g, sq, d)
    delta = (dog.float() * out.reshape(b, hkv, g, sq, d).float()).sum(-1)
    lseg = lse.reshape(b, hkv, g, sq)
    dq = torch.zeros((b, hkv, g, sq, d), device=dev)
    dk = torch.zeros((b, hkv, skv, d), device=dev)
    dv = torch.zeros((b, hkv, skv, d), device=dev)
    for q0 in range(0, sq, q_chunk):
        qi = qg[:, :, :, q0:q0 + q_chunk].float()
        doi = dog[:, :, :, q0:q0 + q_chunk].float()
        cq = qi.shape[3]
        li = lseg[:, :, :, q0:q0 + cq, None]
        di = delta[:, :, :, q0:q0 + cq, None]
        qpos = q0 + q_offset + torch.arange(cq, device=dev)
        for k0 in range(0, skv, kv_chunk):
            ki = k[:, :, None, k0:k0 + kv_chunk].float()
            vi = v[:, :, None, k0:k0 + kv_chunk].float()
            x = torch.matmul(qi, ki.transpose(-1, -2)) * scale
            if softcap is not None:
                t = torch.tanh(x / softcap)
                x = t * softcap
            kpos = k0 + torch.arange(ki.shape[3], device=dev)
            keep = _keep_mask(qpos, kpos, skv, causal, window)
            p = torch.where(keep, torch.exp(x - li), 0.0)
            dv[:, :, k0:k0 + kv_chunk] += torch.matmul(
                p.transpose(-1, -2), doi).sum(2)
            ds = p * (torch.matmul(doi, vi.transpose(-1, -2)) - di) * scale
            if softcap is not None:
                ds = ds * (1.0 - t * t)
            dq[:, :, :, q0:q0 + cq] += torch.matmul(ds, ki)
            dk[:, :, k0:k0 + kv_chunk] += torch.matmul(
                ds.transpose(-1, -2), qi).sum(2)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _tma_ready(t: torch.Tensor) -> bool:
    """TMA takes a bf16 view with a 16-byte-aligned base and (batch, head,
    seq) strides of whole 16-byte units (a size-1 axis takes any)."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return False
    return all(st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3])
               if n > 1)


def _axis_strides(t: torch.Tensor) -> list[int]:
    """(batch, head, seq) strides in elements; a size-1 axis, whose stride
    is never used, gets a positive multiple of 8 that TMA accepts."""
    fill = 8 * -(-t.numel() // 8)
    return [st if n > 1 else fill for n, st in zip(t.shape[:3],
                                                    t.stride()[:3])]


def _kernel_views(*ts: torch.Tensor) -> list[torch.Tensor]:
    """The views the kernels read: bf16 ones that TMA cannot take are
    copied into fresh contiguous tensors (counted in ``copies``), f32 ones
    only when their last stride is not 1."""
    global copies
    fixed = []
    for t in ts:
        if t.dtype == torch.bfloat16 and not _tma_ready(t):
            t = t.clone(memory_format=torch.contiguous_format)
            copies += 1
        elif t.stride(-1) != 1:
            t = t.contiguous()
        fixed.append(t)
    return fixed


def _raise_on(err: int, what: str, q: torch.Tensor, k: torch.Tensor) -> None:
    if err != 0:
        why = (f"tensor map refused, CUresult {err - 1000}" if err >= 1000
               else f"CUDA error {err}")
        raise RuntimeError(f"{what} launch failed: {why} (q {tuple(q.shape)}, "
                           f"kv {tuple(k.shape)}, dtype {q.dtype})")


def _launcher():
    from repro_torch.kernels import _build

    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 5 + [i] * 7 + [ll] * 12
                       + [ctypes.c_float, i, i, ctypes.c_float, i, vp])
        fn.restype = ctypes.c_int
    return fn


def _bwd_launcher():
    from repro_torch.kernels import _build

    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 10 + [i] * 8 + [ll] * 24
                       + [ctypes.c_float, i, i, ctypes.c_float, i, i, vp])
        fn.restype = ctypes.c_int
    return fn


def _check_options(d: int, window, softcap) -> None:
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def _heads_major(b: int, s: int, n: int, d: int, dtype, dev) -> torch.Tensor:
    """A (b, n, s, d) view of a fresh (b, s, n, d) buffer: merging or
    splitting the heads of it afterwards is free."""
    return torch.empty((b, s, n, d), dtype=dtype, device=dev).transpose(1, 2)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    with_lse: bool = False,
):
    """Launch the CUDA kernel (CUDA tensors only): the tensor-core kernel
    for bf16, the SIMT kernel for f32.  ``with_lse`` returns (out, lse),
    lse f32 (b, h, sq) as ``flash_attention_plain_lse`` gives it.

    Takes strided (b, h, s, d) views with a unit last stride, so the
    projections' transposed heads need no copy (a bf16 view that TMA
    cannot read is copied once, and counted in ``copies``); the output is
    a (b, h, sq, d) view of a (b, sq, h, d) buffer, so merging the heads
    afterwards is free.  Launches on PyTorch's current stream without
    synchronising; raises if the launch is refused.
    """
    global launches
    _check(q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}: float32 or bfloat16")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _check_options(d, window, softcap)
    q, k, v = _kernel_views(q, k, v)
    out = _heads_major(b, sq, h, d, q.dtype, dev)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if scale is None:
        scale = d**-0.5
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, hkv, sq, skv, d,
            *_axis_strides(q), *_axis_strides(k), *_axis_strides(v),
            *out.stride()[:3], float(scale), int(causal),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), int(q_offset),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "flash_attention kernel", q, k)
    launches += 1
    return out if lse is None else (out, lse)


def backward_launcher(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
):
    """The checks, views and buffers of one backward (CUDA tensors only):
    returns ``(launch, (dq, dk, dv))``.  ``launch(parts)`` launches the
    kernels whose bits are set in ``parts`` (BWD_DELTA, BWD_DKDV, BWD_DQ),
    in that order, on PyTorch's current stream, counting each in
    ``bwd_launches``; the delta kernel fills the workspace the other two
    read.  ``flash_attention_backward_cuda`` is ``launch(BWD_ALL)``;
    ``chip_smoke.py`` times the dK / dV and dQ kernels alone through it."""
    _check(q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}: float32 or bfloat16")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _check_options(d, window, softcap)
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape)):
        if t.shape != shape or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match q")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != dev):
        raise ValueError(f"lse must be f32 {(b, h, sq)} on {dev}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    q, k, v, dout = _kernel_views(q, k, v, dout)
    out = out if out.stride(-1) == 1 else out.contiguous()
    lse = lse.contiguous()
    grads = (_heads_major(b, sq, h, d, q.dtype, dev),
             _heads_major(b, skv, hkv, d, q.dtype, dev),
             _heads_major(b, skv, hkv, d, q.dtype, dev))
    # delta (b, h, ld); the tensor-core kernels also take lse copied to the
    # same layout, its rows padded to whole 64-row query tiles
    bf16 = q.dtype == torch.bfloat16
    ld = -(-sq // BWD_TILE) * BWD_TILE if bf16 else sq
    work = torch.empty(((2 if bf16 else 1) * b * h * ld,),
                       dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), work.data_ptr(),
            *(t.data_ptr() for t in grads), _DTYPE_CODE[q.dtype], b, h, hkv,
            sq, skv, d, ld, *_axis_strides(q), *_axis_strides(k),
            *_axis_strides(v), *out.stride()[:3], *_axis_strides(dout),
            *(st for t in grads for st in t.stride()[:3]),
            float(d**-0.5 if scale is None else scale), int(causal),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), int(q_offset))
    kernel = _bwd_launcher()

    # _alive: the tensors behind ``args``' pointers live as long as launch
    def launch(parts: int = BWD_ALL,
               _alive=(q, k, v, out, lse, dout, work)) -> None:
        global bwd_launches
        with torch.cuda.device(dev):
            err = kernel(*args, int(parts),
                         torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "flash_attention backward", q, k)
        bwd_launches += bin(parts & BWD_ALL).count("1")

    return launch, grads


def flash_attention_backward_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the three backward kernels (CUDA tensors only): (dq, dk, dv)
    in the inputs' dtype, each a heads-transposed view as the forward's
    output is; the tensor-core kernels for bf16, the SIMT kernels for f32.
    Takes strided (b, h, s, d) views with a unit last stride (a bf16 view
    that TMA cannot read is copied once, and counted in ``copies``);
    ``lse`` is the forward's.  Launches on PyTorch's current stream
    without synchronising; raises if a launch is refused, and never falls
    back to the plain version."""
    launch, grads = backward_launcher(
        q, k, v, out, lse, dout, causal=causal, window=window,
        softcap=softcap, scale=scale, q_offset=q_offset)
    launch(BWD_ALL)
    return grads


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the kernels on CUDA tensors (forward with
    lse, then the backward kernels), the plain versions on CPU tensors.
    Never the plain version on a CUDA tensor: a build or launch error
    raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_chunk,
                kv_chunk, q_offset):
        opts = dict(causal=causal, window=window, softcap=softcap,
                    scale=scale, q_offset=q_offset)
        if q.device.type == "cpu":
            out, lse = flash_attention_plain_lse(
                q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk, **opts)
            opts.update(q_chunk=q_chunk, kv_chunk=kv_chunk)
        else:
            out, lse = flash_attention_cuda(q, k, v, with_lse=True, **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_backward_plain(q, k, v, out, lse, dout,
                                                   **ctx.opts)
        else:
            grads = flash_attention_backward_cuda(q, k, v, out, lse, dout,
                                                  **ctx.opts)
        return (*grads, None, None, None, None, None, None, None)


def flash_attention(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, hkv, skv, d)
    v: torch.Tensor,  # (b, hkv, skv, d)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Batched multi-head attention with GQA (hkv | h): the CUDA kernel for
    CUDA tensors (its own tiles), the plain version over ``q_chunk`` x
    ``kv_chunk`` tiles for CPU tensors.

    The kernel reads kv head ``h // (h // hkv)`` for query head h, where
    the reference repeats K/V ``h // hkv`` times; the result is the same.
    The reference's ``bq`` / ``bkv`` / ``interpret`` have no twin.  With
    grad enabled and an input that requires it, the call goes through
    ``FlashAttention`` (the same forward, plus its lse, and a backward)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                    q_chunk, kv_chunk, q_offset)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk,
                                     q_offset=q_offset)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not "
                         f"{dev}")
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap, scale=scale,
                                q_offset=q_offset)
