"""A/B of the MoE spgemm path between two checkouts, on the card.

    python scripts/moe_spgemm_ab.py outputs TREE OUT.npz
    python scripts/moe_spgemm_ab.py compare A.npz B.npz
    python scripts/moe_spgemm_ab.py phases TREE [17 18]

``outputs`` runs ``models.moe.apply_moe`` under ``impl="spgemm"`` with
the package of checkout ``TREE`` (its ``src``): the reduced deepseek-moe-16b,
jamba-v0.1-52b and llama4-maverick in f32 and bf16 at three token
counts, each without a dispatch spec and under decode specs (full and
random envelopes; backends cuda, dense and stacks; the envelope's
capacity, none, and 4, which drops products), then one deepseek-moe-16b
layer at full width on 8 and on 2 x 256 tokens; it saves every output
and drop count.  ``compare`` prints ``BITEQUAL`` when two such files
hold the same arrays bit for bit.  ``phases`` runs ``TREE``'s
``chip_smoke.py`` phases 17 and 18 (MoE serving at full width) and
prints each one's seconds.  Two checkouts compared in one invocation see
the same card and host.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time


def _setup(tree: str):
    sys.path.insert(0, tree + "/src")
    sys.path.insert(0, tree)
    import torch

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(tree, subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    _build.build()


def outputs(tree: str, out: str) -> None:
    _setup(tree)
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.envelope import union_envelope
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T

    saved = []

    def run(c, p, x, backends):
        e = MoE.moe_dims(c)[0]
        y, _, _ = MoE.apply_moe(c, p, x, collect_stats=True)
        saved.append(y.float().cpu().numpy())
        nb = -(-x.shape[0] * x.shape[1] // c.moe.token_block)
        rng = np.random.default_rng(nb)
        for backend, full in backends:
            m = np.ones((nb, e), bool) if full else rng.random((nb, e)) < 0.5
            env = union_envelope([m], [np.eye(e, dtype=bool)])
            for cap in (env.local_capacity(), None, 4):
                spec = MoE.DispatchSpec(envelope=env, backend=backend,
                                        stack_capacity=cap)
                with MoE.dispatch_scope(spec):
                    y, _, st = MoE.apply_moe(c, p, x, collect_stats=True)
                saved.append(y.float().cpu().numpy())
                saved.append(np.array(int(st["dropped"])))

    every = (("cuda", True), ("cuda", False), ("dense", True),
             ("stacks", False))
    for arch in ("deepseek-moe-16b", "jamba-v0.1-52b",
                 "llama4-maverick-400b-a17b"):
        cfg = get_arch(arch).reduced()
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
                cfg.moe, impl="spgemm"))
            p = MoE.init_moe(c, torch.Generator("cuda").manual_seed(0),
                             T.model_dtype(c))
            for b, s in ((8, 1), (2, 16), (3, 5)):
                x = np.random.default_rng(b * 10 + s).standard_normal(
                    (b, s, c.d_model)).astype(np.float32)
                run(c, p, torch.from_numpy(x).to("cuda", T.model_dtype(c)),
                    every)
    full = get_arch("deepseek-moe-16b")
    c = dataclasses.replace(full, moe=dataclasses.replace(full.moe,
                                                          impl="spgemm"))
    p = MoE.init_moe(c, torch.Generator("cuda").manual_seed(0),
                     torch.bfloat16)
    for b, s in ((8, 1), (2, 256)):
        x = np.random.default_rng(s).standard_normal(
            (b, s, c.d_model)).astype(np.float32)
        # the dense backend materialises the (E, E) bank: 23.6 GB here
        run(c, p, torch.from_numpy(x).to("cuda", torch.bfloat16),
            (("cuda", True), ("cuda", False)))
    np.savez(out, *saved)
    print(f"saved {len(saved)} arrays to {out}", flush=True)


def compare(a: str, b: str) -> None:
    import numpy as np

    x, y = np.load(a), np.load(b)
    bad = [k for k in x.files if not np.array_equal(x[k], y[k])]
    same = not bad and x.files == y.files
    print("BITEQUAL" if same else "DIFFER", len(x.files), bad[:10],
          flush=True)


def phases(tree: str, which: list[int]) -> None:
    _setup(tree)
    import numpy as np
    import torch

    import chip_smoke as CS
    from repro_torch.configs import get_arch
    from repro_torch.kernels import block_spgemm as K
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import stacks as S
    from repro_torch.launch import serve
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T

    calls = {17: (CS.phase_moe_serve, (torch, K, FA, T, MoE, serve)),
             18: (CS.phase_jamba, (torch, np, K, S, FA, T, MoE, serve,
                                   get_arch))}
    for n in which:
        fn, args = calls[n]
        t0 = time.perf_counter()
        fn(*args)
        print(f"{tree}: phase {n} took {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    cmd, rest = sys.argv[1], sys.argv[2:]
    if cmd == "outputs":
        outputs(*rest)
    elif cmd == "compare":
        compare(*rest)
    elif cmd == "phases":
        phases(rest[0], [int(n) for n in rest[1:]] or [17, 18])
    else:
        raise SystemExit(__doc__)
