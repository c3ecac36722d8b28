"""Time the flash kernels' wrappers at the main path's shapes on the card.

    PYTHONPATH=src python scripts/time_flash.py [--reps 50]

Builds the kernels, then prints one JSON line: for each attention shape
that ``chip_smoke.py`` times (phases 9, 18, 20, 21), the median
CUDA-event time of one call of ``kernels.flash_attention.flash_attention``
(bf16; the host's Python before the launch counts where the card waits
for it), the same call through the op ``repro_torch::flash_attention_fwd``
where the package has one, and ``scaled_dot_product_attention``; and the
backward (``flash_attention_backward_cuda``) at olmo-1b's training shape.
It needs nothing newer than the package's forward and backward wrappers,
so pointing PYTHONPATH at another checkout's ``src`` times that tree:
two trees compared in one session (parent, change, change, parent) see
the same card and host.
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

# (name, b, h, hkv, sq, skv, d, causal)
SHAPES = (
    ("olmo", 8, 16, 16, 2048, 2048, 128, True),
    ("jamba", 8, 32, 8, 2048, 2048, 128, True),
    ("whisper encoder", 8, 20, 20, 1500, 1500, 64, False),
    ("whisper cross", 8, 20, 20, 32, 1500, 64, False),
    ("whisper self", 8, 20, 20, 32, 32, 64, True),
    ("pixtral text", 8, 32, 8, 1024, 1024, 128, True),
    ("pixtral fused", 8, 32, 8, 1280, 1280, 128, True),
)


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA

    _build.build()
    op = getattr(torch.ops.repro_torch, "flash_attention_fwd", None) \
        if hasattr(torch.ops, "repro_torch") else None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator("cuda").manual_seed(0)
    out = {"tree": FA.__file__, "forward": {}}
    for name, b, h, hkv, sq, skv, d, causal in SHAPES:
        q, k, v = (torch.randn((b, n, s, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for n, s in ((h, sq), (hkv, skv), (hkv, skv)))
        gqa = dict(enable_gqa=True) if hkv < h else {}
        row = {
            "kernel": _time_ms(lambda: FA.flash_attention(
                q, k, v, causal=causal), args.reps),
            "sdpa": _time_ms(lambda: sdpa(q, k, v, is_causal=causal, **gqa),
                             args.reps),
        }
        if op is not None:
            row["op"] = _time_ms(lambda: op(q, k, v, causal, None, None,
                                            None, 0, False), args.reps)
        out["forward"][name] = row
    b, h, s, d = 8, 16, 2048, 128
    q, k, v, dout = (torch.randn((b, h, s, d), generator=gen, device="cuda",
                                 dtype=torch.bfloat16) for _ in range(4))
    o, lse = FA.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    out["backward olmo"] = _time_ms(lambda: FA.flash_attention_backward_cuda(
        q, k, v, o, lse, dout, causal=True), args.reps)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
