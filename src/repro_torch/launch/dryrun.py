"""Multi-pod dry run: trace every (arch x shape x mesh) cell — the twin of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's step for the production
meshes — single pod (16, 16) = 256 chips and two pods (2, 16, 16) = 512
— on 512 forced host devices.  The port traces it: each rank of the mesh
is its own ``meta`` device (``make_production_mesh(abstract=True)``), the
parameters, optimizer state, cache and batch are ``meta`` tensors laid out
by the specs (nothing is allocated, no card is touched), and one step of
the cell's kind (``build_train_step`` / ``build_prefill_step`` /
``build_serve_step``) runs under ``roofline/hlo_cost.py``'s tracer, the
flash kernels as their ops.  Layers run in a Python loop, so a cell is
traced with ``layer_pattern_period`` layers and with twice that and
extended linearly to the arch's depth (``hlo_cost.extrapolate``).

Each cell writes one JSON record (the reference's keys, ``trace_s`` — the
host seconds of the two traces — in place of ``lower_s`` / ``compile_s``,
and per device the reference's analytic flash traffic beside the traced
bytes of the flash ops, ``flash_kernel_bytes`` / ``flash_traced_bytes``)
with the three-term roofline (``roofline.analyze``, the H100's constants)
and the memory per device: the arguments the specs place on a rank (its
parameter, optimizer-state, cache and batch shards), the temporaries (the
traced peak less the arguments) and the peak, beside the card's 80 GiB.
Records go to ``artifacts/dryrun_torch/`` (the reference's to
``artifacts/dryrun/``); re-runs skip complete cells unless ``--force``.
A cell that ``shape_applicable`` rejects is skipped with its reason; a
cell that fails (MoE's ``spgemm`` impl on a mesh raises
``NotImplementedError`` naming its ROADMAP.md item) records ``ok: false``
with the error, and the run exits 1.  Every family traces: whisper's
cells carry its frames through the full-depth encoder in both traces
(exact: the encoder's counts cancel in the depth extension), rwkv6's
and mamba's recurrences one op a chunk.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi \\
        --arch qwen2-72b --shape train_4k --force
    PYTHONPATH=src python -m repro_torch.launch.dryrun --options remat=full
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import traceback

from repro_torch import roofline as RL
from repro_torch.config import SHAPES, shape_applicable
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (
    StepOptions,
    abstract_state,
    batch_sds,
    build_prefill_step,
    build_serve_step,
    build_train_step,
    init_opt_state,
    sds_of,
    sds_zeros,
)
from repro_torch.optim import AdamWConfig
from repro_torch.parallel.sharding import param_shapes
from repro_torch.roofline import hlo_cost as HC

MESHES = ("single", "multi")


def cell_id(arch: str, shape: str, mesh: str, tag: str = "") -> str:
    suffix = f"__{tag}" if tag else ""
    return f"{arch}__{shape}__{mesh}{suffix}"


def parse_options(kvs: list[str]) -> StepOptions:
    kwargs = {}
    for kv in kvs:
        k, v = kv.split("=", 1)
        field = {f.name: f for f in dataclasses.fields(StepOptions)}[k]
        if v.lower() == "none":
            kwargs[k] = None
        elif field.type in ("bool", bool):
            kwargs[k] = v.lower() in ("1", "true", "yes")
        elif field.type in ("int", int):
            kwargs[k] = int(v)
        elif field.type in ("float", float):
            kwargs[k] = float(v)
        else:
            kwargs[k] = v
    return StepOptions(**kwargs)


def _flash_kernel_bytes(cfg, shape, mesh) -> float:
    """The reference's analytic per-device HBM traffic of the flash kernel:
    Q/K/V/O streamed once per pass, ~3 passes (fwd + bwd recompute + bwd
    grads); 0 for decode (kept beside the traced bytes of the flash ops,
    ``roofline.analyze``)."""
    if shape.kind == "decode":
        return 0.0
    axes = dict(mesh.shape)
    m = axes.get("model", 1)
    dsz = axes.get("data", 1) * axes.get("pod", 1)
    b_local = max(shape.global_batch // dsz, 1)
    h_local = cfg.n_heads // m if cfg.n_heads % m == 0 else cfg.n_heads
    kv_local = cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else cfg.n_kv_heads
    kinds = cfg.layer_kinds()
    reps = cfg.n_layers // len(kinds)
    n_attn = sum(1 for k in kinds if k["mixer"] == "attention") * reps
    if cfg.encoder is not None:
        n_attn += cfg.encoder.n_layers + cfg.n_layers  # self + cross
    per_layer = (2 * h_local + 2 * kv_local) * b_local * shape.seq_len * cfg.hd * 2
    return 3.0 * n_attn * per_layer


def step_and_args(cfg, shape, mesh, options: StepOptions):
    """The cell's step and its arguments as ``meta`` tensors laid out by
    the specs on ``mesh``'s ranks (or, with no mesh, one-device tensors on
    ``meta``)."""
    dev = "meta" if mesh is None else mesh.devices[0].type
    put = lambda tree: sds_zeros(mesh, tree, device=dev)
    if shape.kind == "train":
        opt = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
        step = build_train_step(cfg, shape, opt=opt, options=options,
                                device=dev, mesh=mesh)
        if mesh is None:
            params = put(sds_of(param_shapes(cfg)))
            state = init_opt_state(params, opt, options)
            return step, (params, state, put(batch_sds(cfg, shape)))
        p_shape, o_shape, p_spec, o_spec = abstract_state(cfg, mesh, opt,
                                                          options)
        return step, (put(sds_of(p_shape, p_spec)),
                      put(sds_of(o_shape, o_spec)),
                      put(batch_sds(cfg, shape, mesh)))
    build = build_prefill_step if shape.kind == "prefill" else build_serve_step
    step, (p_sds, c_sds, b_sds) = build(cfg, shape, options=options,
                                        device=dev, mesh=mesh)
    params, cache, batch = put(p_sds), put(c_sds), put(b_sds)
    if shape.kind == "prefill":
        return step, (params, cache, batch)
    # decode: one token against a full seq_len-deep cache
    return step, (params, cache, batch["tokens"], shape.seq_len - 1)


def trace_step(cfg, shape, mesh, options: StepOptions,
               n_layers: int | None = None) -> HC.CostReport:
    """One traced step of the cell (``n_layers`` of the arch's layers)."""
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    step, args = step_and_args(cfg, shape, mesh, options)
    devices = 1 if mesh is None else mesh.n_devices
    _, cost = HC.trace(step, *args, devices=devices)
    return cost


def trace_cell(cfg, shape, mesh, options: StepOptions) -> HC.CostReport:
    """The cell's counts at the arch's depth: traces of one and two
    layer-pattern periods, extended linearly."""
    period = cfg.layer_pattern_period
    gc.collect()
    one = trace_step(cfg, shape, mesh, options, period)
    two = trace_step(cfg, shape, mesh, options, 2 * period)
    return HC.extrapolate(one, two, period, 2 * period, cfg.n_layers)


def run_cell(
    arch_id: str,
    shape_id: str,
    mesh_kind: str,
    options: StepOptions,
    *,
    verbose: bool = True,
    moe_impl: str | None = None,
    cfg=None,
    mesh=None,
) -> dict:
    """One cell's record.  ``cfg`` / ``mesh`` replace the arch's config and
    the production mesh (tests run reduced configs on small meshes)."""
    cfg = get_arch(arch_id) if cfg is None else cfg
    if moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=moe_impl))
    shape = SHAPES[shape_id]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    abstract=True)
    n_chips = mesh.size

    record: dict = {
        "arch": arch_id,
        "shape": shape_id,
        "mesh": mesh_kind,
        "mesh_shape": list(mesh.sizes),
        "mesh_axes": list(mesh.axis_names),
        "n_chips": n_chips,
        "options": dataclasses.asdict(options),
        "ok": False,
    }

    applicable, reason = shape_applicable(cfg, shape)
    if not applicable:
        record.update(skipped=True, skip_reason=reason, ok=True)
        return record

    t0 = time.time()
    cost = trace_cell(cfg, shape, mesh, options)
    t_trace = time.time() - t0
    flash_bytes = _flash_kernel_bytes(cfg, shape, mesh)
    report = RL.analyze(
        cost,
        n_chips=n_chips,
        model_flops_total=RL.model_flops(cfg, shape),
    )
    record.update(
        ok=True,
        trace_s=round(t_trace, 2),
        roofline=report.to_json(),
        params_total=cfg.param_count(),
        params_active=cfg.active_param_count(),
        flash_kernel_bytes=flash_bytes,
        flash_traced_bytes=cost.flash_bytes / n_chips,
    )
    if verbose:
        mem_gb = report.memory["peak_bytes"] / 2**30
        print(
            f"  trace {t_trace:6.1f}s  mem/dev {mem_gb:6.2f} GiB (of "
            f"{RL.HBM_BYTES / 2**30:.0f})  dominant={report.dominant}  "
            f"comp={report.compute_s*1e3:.2f}ms mem={report.memory_s*1e3:.2f}ms "
            f"coll={report.collective_s*1e3:.2f}ms",
            flush=True,
        )
    return record


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", nargs="*", default=None, help="arch ids (default all)")
    ap.add_argument("--shape", nargs="*", default=None, help="shape ids (default all)")
    ap.add_argument("--mesh", nargs="*", default=None, choices=MESHES)
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="artifact suffix (perf variants)")
    ap.add_argument(
        "--options", nargs="*", default=[], help="StepOptions overrides k=v"
    )
    ap.add_argument("--moe-impl", default=None, choices=[None, "tp", "ep", "dense"],
                    help="override MoEConfig.impl for MoE archs")
    args = ap.parse_args()

    archs = args.arch or list(ARCH_IDS)
    shapes = args.shape or list(SHAPES)
    meshes = args.mesh or list(MESHES)
    options = parse_options(args.options)

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for mesh_kind in meshes:
        for arch_id in archs:
            arch_id = arch_id.replace("-", "_").replace(".", "_")
            for shape_id in shapes:
                cid = cell_id(arch_id, shape_id, mesh_kind, args.tag)
                path = os.path.join(args.out, cid + ".json")
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        if json.load(f).get("ok"):
                            print(f"[skip] {cid} (done)", flush=True)
                            continue
                print(f"[cell] {cid}", flush=True)
                try:
                    record = run_cell(arch_id, shape_id, mesh_kind, options,
                                      moe_impl=args.moe_impl)
                except Exception as e:  # noqa: BLE001 — record and continue
                    record = {
                        "arch": arch_id,
                        "shape": shape_id,
                        "mesh": mesh_kind,
                        "ok": False,
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    failures.append(cid)
                    print(f"  FAILED: {record['error'][:300]}", flush=True)
                with open(path, "w") as f:
                    json.dump(record, f, indent=1)
                gc.collect()  # the traces' meta tensors and graphs

    print(f"\ndone; {len(failures)} failures", flush=True)
    for cid in failures:
        print(f"  FAIL {cid}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
