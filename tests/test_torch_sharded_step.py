"""The sharded train step (``launch.steps.build_train_step(..., mesh=)``,
``parallel/runtime.py``) against the port's one-device step, on CPU meshes
of ranks.

The reference's sharded step fails under the installed jax (its
``train_steps`` / ``microbatch`` checks are in the red set), so the oracle
is the port's one-device step, itself held to the reference's on a 1 x 1
mesh (``tests/test_torch_train_step.py``).  Both start from the same
parameters (drawn once, then sharded) and take three steps on the same
batches; after the first and the third, every leaf of the gathered params,
mu and nu (and each rank's compression residual) is compared, and at every
step the loss and the grad norm.

Where the sharded step rounds partial sums to bf16, the oracle is a plain
one-device emulation of those roundings, held at the same 1e-4:
``bf16_reduce`` (each model rank's share of a row-parallel product —
its heads of ``out_proj``, its d_ff rows of the MLP's down-projection —
rounded to bf16, the parts summed in bf16 in rank order) and
``compress_grads`` (each data rank's gradient, its rows' share of the
mean loss, compressed with that rank's residual and the payloads summed
in bf16; a leaf FSDP shards over ``data`` is summed in f32 first, by its
gather's backward, and compressed once).

Tolerances.  The oracle also runs from eight one-ulp starts (every
entry moved by -1, 0 or +1 ulp, seeded): what they move is its own
sensitivity.  The same arithmetic summed in other orders (the psums of
tensor-parallel partials, the vocab-parallel log-sum-exp, the data-axis
gradient sums) is held to 1e-4 (+ 1e-4 relative), entry by entry.  Loss,
ce and grad norm: 1e-4.  mu and nu: also the leaf's largest difference within 1e-4 of its largest entry
or twice the one-ulp starts' (nu is ~1e-7 here, so this is what holds
it).  A parameter entry whose gradient RMS sqrt(nu_hat) fell below NOISE
(1e-6) at some step is held to 2 lr a step: AdamW moves it by a ratio of
two numbers at f32 noise level (as in ``test_torch_train_step.py``); an
entry whose gradient is exactly zero (an embedding row no token of the
batch names) is not noise.  Every other parameter entry off the 1e-4
rule must be one a one-ulp start also moves past it: reduced qwen1.5-4b
has such ill-conditioned entries (6-24 of 720,000 after three steps, in
the token tables, the first norm and the attention and MLP weights of
both layers); no other f32 case has any.  A residual may differ where
the bf16 rounding of g + r went the other way (by one bf16 spacing), in
no larger a share of a leaf than 1e-3 or twice a one-ulp start's.  Past
its first step a ``bf16_reduce`` run is chaotic (an entry whose gradient
is smaller than one bf16 rounding's change takes either sign, and a
one-ulp start moves 6,000-150,000 parameter entries past the rule, the
moments by percents of their largest entry and the grad norm by up to
3e-3), so there the metrics are held to 1e-4 or twice the largest
one-ulp difference, the moments leaf by leaf, and the parameters may be
off only in leaves, and in no more entries, than the closest one-ulp
start's.  Planted faults (a
data rank's gradient shards swapped with another's, or zeroed, and the
``bf16_reduce`` step against the oracle without its roundings) fail the
check.  The bytes per rank of every step equal ``launch.steps.step_bytes``,
a count made from the specs alone.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.configs import get_arch
from repro_torch.core import transport as TR
from repro_torch.data import DataConfig, SyntheticLMData, make_global_batch
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_update, compress_grads
from repro_torch.optim.tree import leaves, named_leaves, tree_map
from repro_torch.parallel import sharding as SH

SEQ, BATCH, CHUNK, N_STEPS = 32, 8, 16, 3
TOL, NOISE, LR, N_ULP = 1e-4, 1e-6, 3e-3, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(arch):
    if isinstance(arch, ArchConfig):
        return arch
    if arch == "qwen-replicated-heads":
        # 3 heads on a model axis of 2: attention runs whole on each model
        # rank, its column-sharded weights gathered first (qwen1.5-4b's 20
        # heads on 16)
        return dataclasses.replace(get_arch("qwen1.5-4b").reduced(),
                                   n_heads=3, n_kv_heads=3, head_dim=32)
    return get_arch(arch).reduced()


def _mesh(dims):
    names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    return make_mesh(dims, names, "cpu")


CASES = [
    ("olmo-1b", (2, 2), dict(remat="none")),
    ("olmo-1b", (2, 2), dict(remat="full")),
    ("olmo-1b", (2, 2), dict(remat="dots")),
    ("gemma2-27b", (2, 2), dict(remat="full")),
    ("qwen1.5-4b", (2, 2), dict(remat="dots")),
    ("olmo-1b", (4, 1), dict(remat="full")),
    ("gemma2-27b", (4, 1), dict(remat="none")),
    ("olmo-1b", (1, 2), dict(remat="full")),
    ("qwen1.5-4b", (1, 2), dict(remat="none")),
    ("olmo-1b", (2, 1, 2), dict(remat="full", head_2p5d=True)),
    ("gemma2-27b", (2, 1, 2), dict(remat="dots", head_2p5d=True)),
    ("qwen1.5-4b", (2, 1, 2), dict(remat="none", head_2p5d=True,
                                   fsdp_axis=("pod", "data"))),
    ("olmo-1b", (2, 2, 2), dict(remat="full", fsdp_axis=("pod", "data"))),
    ("olmo-1b", (2, 2), dict(remat="full", microbatch=2)),
    ("olmo-1b", (2, 2), dict(remat="full", zero1=True)),
    ("olmo-1b", (2, 2), dict(remat="full", compress_grads=True)),
    ("gemma2-27b", (2, 2), dict(remat="full", seq_parallel=True)),
    ("qwen1.5-4b", (2, 2), dict(remat="dots", seq_parallel=True,
                                zero1=True, microbatch=2)),
    ("gemma2-27b", (2, 2), dict(remat="none", zero1=True,
                                compress_grads=True)),
    ("qwen-replicated-heads", (1, 2), dict(remat="full")),
    ("qwen-replicated-heads", (2, 2), dict(remat="full", seq_parallel=True)),
    ("olmo-1b", (2, 2), dict(remat="full", fsdp_axis=None)),
    ("olmo-1b", (2, 2), dict(remat="full", bf16_reduce=True)),
    ("gemma2-27b", (2, 2), dict(remat="dots", bf16_reduce=True,
                                seq_parallel=True)),
]


def _id(case):
    arch, dims, opts = case
    flags = "-".join(f"{k}={v}" for k, v in opts.items())
    return f"{arch}-{'x'.join(map(str, dims))}-{flags}"


# ---------------------------------------------------------------------------
# the oracle: the one-device step, with the sharded step's bf16 roundings
# emulated plainly where it has them
# ---------------------------------------------------------------------------


def _bf16_sum(parts):
    total = parts[0].to(torch.bfloat16)
    for y in parts[1:]:
        total = total + y.to(torch.bfloat16)
    return total


def _bf16_partials(monkeypatch, cfg, m):
    """The one-device model's row-parallel products as ``m`` model ranks
    compute them under ``bf16_reduce``: each rank's product over its
    contiguous share of the contraction rounded to bf16, the parts summed
    in bf16 in rank order (heads that do not divide ``m`` run whole on
    every rank: one product, one rounding)."""
    out_proj, apply_mlp = A.out_proj, L.apply_mlp
    m_attn = m if cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0 else 1

    def split_out_proj(cfg, p, attn):
        h = attn.shape[1] // m_attn
        rows = h * attn.shape[3]
        return _bf16_sum([out_proj(cfg, {"wo": p["wo"][j * rows:(j + 1)
                                                       * rows]},
                                   attn[:, j * h:(j + 1) * h])
                          for j in range(m_attn)])

    def split_mlp(cfg, p, x):
        f = p["w_out"].shape[0] // m
        return _bf16_sum([apply_mlp(cfg, {
            k: v[j * f:(j + 1) * f] if k == "w_out" else v[:, j * f:(j + 1)
                                                           * f]
            for k, v in p.items()}, x) for j in range(m)])

    monkeypatch.setattr(A, "out_proj", split_out_proj)
    monkeypatch.setattr(L, "apply_mlp", split_mlp)


class _Oracle:
    """``init(params) -> state`` and ``step(params, state, batch)``: the
    port's one-device step, or under ``compress_grads`` a plain loop that
    compresses each data rank's gradient as the sharded step does (f32
    sum first for the leaves whose param spec shards every batch axis);
    under ``bf16_reduce`` run inside ``_bf16_partials``."""

    def __init__(self, cfg, mesh, shape, opt, options, p_spec):
        self.cfg, self.mesh, self.opt, self.options = cfg, mesh, opt, options
        self.plain = ST.build_train_step(cfg, shape, opt=opt,
                                         options=options, device="cpu")
        self.batch_axes = ST._batch_names(mesh)
        self.n = int(np.prod([mesh.shape[a] for a in self.batch_axes]))
        self.fsdp = [set(self.batch_axes) <= {a for e in s
                                              for a in SH.entry_axes(e)}
                     for s in leaves(p_spec)]
        self.compress = options.compress_grads
        assert not (self.compress and options.microbatch > 1)

    def init(self, params):
        state = ST.init_opt_state(params, self.opt, self.options)
        if self.compress:  # one residual per data rank of every leaf
            state["efb"] = [[torch.zeros_like(r) for _ in range(self.n)]
                            for r in leaves(state["efb"])]
        return state

    def step(self, params, state, batch):
        if not self.compress:
            return self.plain(params, state, batch)
        rows = batch["tokens"].shape[0] // self.n
        grads, loss = [], 0.0
        for j in range(self.n):
            mb = {k: v[j * rows:(j + 1) * rows] for k, v in batch.items()}
            live = tree_map(lambda t: t.detach().requires_grad_(), params)
            lj, _ = T.loss_fn(self.cfg, live, mb, remat=self.options.remat,
                              loss_chunk=self.options.loss_chunk)
            share = lj / self.n  # the rank's rows over the global tokens
            grads.append(torch.autograd.grad(share, leaves(live)))
            loss = loss + share.detach()
        payload, efb = [], []
        for i, (fsdp, res) in enumerate(zip(self.fsdp, state["efb"])):
            gs = [g[i] for g in grads]
            if fsdp:  # summed by the FSDP gather's backward, then one
                total = gs[0]
                for g in gs[1:]:
                    total = total + g
                q, r = compress_grads(total, res[0])
                payload.append(q.float())
                efb.append([r] * self.n)
            else:
                q, r = zip(*(compress_grads(g, rj)
                             for g, rj in zip(gs, res)))
                payload.append(_bf16_sum(q).float())
                efb.append(list(r))
        it = iter(payload)
        core = {k: state[k] for k in ("mu", "nu", "step")}
        params, core, om = adamw_update(
            self.opt, params, tree_map(lambda _: next(it), params), core)
        return params, dict(core, efb=efb), dict(
            ce=loss, moe_aux=torch.zeros(()), loss=loss, **om)


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


def _close(got, want, ulps, tol, what, entrywise=True):
    """Entry by entry within ``tol`` (+ ``tol`` relative) when
    ``entrywise``, and the leaf's largest difference within ``tol`` of
    its largest entry or twice the oracle's own from its one-ulp starts
    (``ulps``)."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    assert not entrywise or bool((d <= tol + tol * w).all()), (
        what, float(d.max()))
    floor = max(float((u.float() - want.float()).abs().max()) for u in ulps)
    assert float(d.max()) <= max(tol * float(w.max()), 2 * floor), (
        what, float(d.max()), float(w.max()), floor)


def _params_off(got, want, noisy, tol, t) -> dict:
    """{leaf name: mask} of the entries of ``got`` past the rule against
    ``want`` (noisy entries held to 2 lr a step, asserted here)."""
    off = {}
    for (name, g), w, m in zip(named_leaves(got), leaves(want), noisy):
        assert g.dtype == w.dtype and g.shape == w.shape
        d = (g.float() - w.float()).abs()
        assert float(d.max()) <= 2 * LR * t, (name, float(d.max()))
        mask = (d > tol + tol * w.float().abs()) & ~m
        if mask.any():
            off[name] = mask
    return off


def _check_residuals(mesh, efb, want, ulps, p_spec):
    """Each rank's residual against its data rank's in the oracle, its
    spec's chunk: equal to 1e-6 but where the bf16 rounding of g + r went
    the other way, in no larger a share of the leaf than 1e-3 or twice the
    oracle's own from its one-ulp starts, and there by at most one bf16
    spacing (twice the leaf's largest residual)."""
    names = mesh.axis_names
    for shards, per_rank, spec, *us in zip(leaves(efb), want, leaves(p_spec),
                                           *ulps):
        top = max(float(r.abs().max()) for r in per_rank)
        own = max(float(((u[j] - per_rank[j]).abs() > 1e-6).float().mean())
                  for u in us for j in range(len(per_rank)))
        for r, t in enumerate(shards):
            c = dict(zip(names, mesh.coords(r)))
            j = c["data"] + mesh.shape["data"] * c.get("pod", 0)
            d = (t - SH.take(per_rank[j], SH.chunk_index(mesh, spec, r))).abs()
            flips = float((d > 1e-6).float().mean())
            assert flips <= max(1e-3, 2 * own), (r, flips, own)
            assert float(d.max()) <= 2 * top + 1e-6, (r, float(d.max()), top)


def _one_ulp(params, seed):
    """``params`` with every entry moved by -1, 0 or +1 ulp (seeded)."""
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda w: w * (1 + 2.0**-23 * torch.randint(
        -1, 2, w.shape, generator=gen).to(w.dtype)), params)


def _embeds(cfg, embeds, step) -> dict:
    """The step's model inputs beside the tokens: ``embeds`` maps
    ``frame_embeds`` / ``patch_embeds`` to their rows a sample, drawn
    with numpy (seeded by the step)."""
    rng = np.random.default_rng(100 + step)
    return {name: torch.from_numpy(rng.standard_normal(
        (BATCH, n, cfg.d_model)).astype(np.float32)).to(T.model_dtype(cfg))
        for name, n in (embeds or {}).items()}


def _run_case(arch, dims, opts, monkeypatch, emulate=True,
              noisy_share=2e-2, embeds=None, witness=False):
    """Three sharded steps against the oracle (the module docstring's
    rules); at most ``noisy_share`` of the parameter entries may take the
    noise rule.  ``embeds``: whisper's frames / pixtral's patches in
    every batch (``_embeds``).  ``witness``: the metrics are held to
    ``TOL`` or twice the oracle's own spread from its one-ulp starts,
    where that is more (a run whose sum order alone moves a metric past
    ``TOL``), as a chaotic run's are."""
    cfg, mesh = _cfg(arch), _mesh(dims)
    shape = ShapeConfig("train", SEQ, BATCH, "train")
    opt = AdamWConfig(lr=LR)
    options = ST.StepOptions(loss_chunk=CHUNK, **opts)
    params = T.init_params(cfg, 0, device="cpu")
    _, _, p_spec, o_spec = ST.abstract_state(cfg, mesh, opt, options)
    oracle = _Oracle(cfg, mesh, shape, opt, options, p_spec)
    sharded = ST.build_train_step(cfg, shape, opt=opt, options=options,
                                  device="cpu", mesh=mesh)
    p1, s1 = params, oracle.init(params)
    # the oracle from one-ulp starts: its own sensitivity
    ulps = [[_one_ulp(params, seed), oracle.init(params)]
            for seed in range(1, N_ULP + 1)]
    p2, s2 = ST.init_sharded(cfg, mesh, params, opt, options)
    want_bytes = ST.step_bytes(cfg, mesh, shape, options, opt,
                               frames="frame_embeds" in (embeds or {}))
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                      global_batch=BATCH, seed=0))
    noisy = None
    for i in range(N_STEPS):
        extra = _embeds(cfg, embeds, i)
        batch = dict(make_global_batch(data, i, "cpu"), **extra)
        with monkeypatch.context() as mp:
            if options.bf16_reduce and emulate:
                _bf16_partials(mp, cfg, mesh.shape["model"])
            p1, s1, m1 = oracle.step(p1, s1, batch)
            mu_ = []
            for u in ulps:
                u[0], u[1], m = oracle.step(*u, batch)
                mu_.append(m)
        TR.reset_bytes()
        p2, s2, m2 = sharded(p2, s2, dict(make_global_batch(data, i, mesh),
                                          **extra))
        assert TR.bytes_moved() == want_bytes
        assert sorted(m2) == sorted(m1)
        # past its first step a bf16_reduce run is chaotic: from a one-ulp
        # start the oracle moves tens of thousands of parameter entries
        # past the rule (an entry whose gradient is smaller than what one
        # bf16 rounding changes takes either sign), its moments by percents
        # of their largest entry and its grad norm by up to 3e-3; such a
        # run is held to twice the oracle's own spread, leaf by leaf
        chaotic = options.bf16_reduce and i > 0
        for name in ("loss", "ce", "moe_aux", "grad_norm"):
            w = float(m1[name])
            floor = max(abs(float(m[name]) - w) for m in mu_)
            lim = TOL * max(1.0, abs(w))
            assert abs(float(m2[name]) - w) <= (max(lim, 2 * floor)
                                                if chaotic or witness
                                                else lim), (
                i, name, float(m2[name]), w, floor)
        b2c = 1.0 - opt.b2 ** (i + 1)
        now = [(x > 0) & (torch.sqrt(x.float() / b2c) < NOISE)
               for x in leaves(s1["nu"])]
        noisy = now if noisy is None else [a | b for a, b in zip(noisy, now)]
        if i not in (0, N_STEPS - 1):
            continue
        for name in ("mu", "nu"):
            got = SH.unshard_tree(mesh, s2[name], o_spec[name])
            for (leaf, g), w, *us in zip(named_leaves(got), leaves(s1[name]),
                                         *(leaves(u[1][name]) for u in ulps)):
                assert g.dtype == w.dtype and g.shape == w.shape
                _close(g, w, us, TOL, f"{name} {leaf}", not chaotic)
        if options.compress_grads:
            _check_residuals(mesh, s2["efb"], s1["efb"],
                             [u[1]["efb"] for u in ulps], p_spec)
        assert int(s2["step"]) == int(s1["step"]) == i + 1
        off = _params_off(SH.unshard_tree(mesh, p2, p_spec), p1, noisy,
                          TOL, i + 1)
        ulp_off = [_params_off(u[0], p1, noisy, TOL, i + 1) for u in ulps]
        ill = {}
        for o in ulp_off:
            for name, mask in o.items():
                ill[name] = ill.get(name, torch.zeros_like(mask)) | mask
        if chaotic:
            # off only in leaves a one-ulp start moves, and in no more
            # entries than the closest of them
            count = lambda o: sum(int(m.sum()) for m in o.values())
            assert set(off) <= set(ill), (i, sorted(set(off) - set(ill)))
            assert count(off) <= min(map(count, ulp_off)), (
                i, count(off), [count(o) for o in ulp_off])
        else:
            # an entry off the rule must be one the oracle itself moves
            # past it from a one-ulp start
            left = {name: int((mask & ~ill[name]).sum()) if name in ill
                    else int(mask.sum()) for name, mask in off.items()}
            assert not any(left.values()), (i, left)
    n_noisy = sum(int(m.sum()) for m in noisy)
    assert n_noisy <= noisy_share * sum(m.numel() for m in noisy)


@pytest.mark.parametrize("arch,dims,opts", CASES, ids=[_id(c) for c in CASES])
def test_sharded_step_matches_one_device(arch, dims, opts, monkeypatch):
    _run_case(arch, dims, opts, monkeypatch)


def _plant(fault):
    """A ``_adamw_sharded`` whose gradient shards are faulty: ``swap`` —
    every rank takes the shard of the rank one data index over (the wrong
    data rank's chunk); ``zero`` — rank 0's shards are zeros."""
    real = ST._adamw_sharded

    def faulty(mesh, opt, params, grads, *rest, **kw):
        if fault == "zero":
            grads = [[torch.zeros_like(g[0]), *g[1:]] for g in grads]
        else:
            names = mesh.axis_names
            rank = {mesh.coords(r): r for r in range(mesh.size)}
            d = names.index("data")

            def other(r):
                c = list(mesh.coords(r))
                c[d] = (c[d] + 1) % mesh.shape["data"]
                return rank[tuple(c)]

            grads = [[g[other(r)] for r in range(mesh.size)] for g in grads]
        return real(mesh, opt, params, grads, *rest, **kw)

    return faulty


@pytest.mark.parametrize("fault,case", [
    ("swap", CASES[18]), ("zero", CASES[18]), ("zero", CASES[22]),
    ("swap", CASES[23]), ("f32-oracle", CASES[22])],
    ids=["swap-zero1-compress", "zero-zero1-compress", "zero-bf16_reduce",
         "swap-bf16_reduce-seq_parallel", "f32-oracle-bf16_reduce"])
def test_a_planted_fault_fails_the_check(fault, case, monkeypatch):
    """The check fails a sharded step that applies another data rank's
    gradient shards or a zero shard, and it resolves ``bf16_reduce``'s
    roundings: against the one-device step without them it fails too."""
    if fault != "f32-oracle":
        monkeypatch.setattr(ST, "_adamw_sharded", _plant(fault))
    with pytest.raises(AssertionError):
        _run_case(*case, monkeypatch, emulate=fault != "f32-oracle")


def test_shards_are_the_specs_chunks():
    """Every rank's parameter shard has the local shape its spec gives,
    and the moments under ZeRO-1 are split where the parameters are
    not."""
    cfg, mesh = get_arch("olmo-1b").reduced(), _mesh((2, 2))
    opt = AdamWConfig(lr=LR)
    options = ST.StepOptions(zero1=True)
    params = T.init_params(cfg, 0, device="cpu")
    p2, s2 = ST.init_sharded(cfg, mesh, params, opt, options)
    _, _, p_spec, o_spec = ST.abstract_state(cfg, mesh, opt, options)
    assert p_spec["blocks"][0]["attn"]["wq"] == SH.P(None, "model")
    assert o_spec["mu"]["blocks"][0]["attn"]["wq"] == SH.P("data", "model")
    for x, s, full in zip(leaves(p2), leaves(p_spec), leaves(params)):
        for t in x:
            assert tuple(t.shape) == SH.local_shape(full.shape, s, mesh)
    wq = s2["mu"]["blocks"][0]["attn"]["wq"]
    assert tuple(wq[0].shape) == (cfg.d_model // 2, cfg.n_heads * cfg.hd
                                  // 2)
    full_back = SH.unshard_tree(mesh, p2, p_spec)
    for a, b in zip(leaves(full_back), leaves(params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,item", [
    ("jamba-v0.1-52b", "15c.2"), ("deepseek-moe-16b", "15c.2"),
    ("rwkv6-7b", None), ("whisper-large-v3", None),
    ("pixtral-12b", None)])
def test_non_dense_family_raises(arch, item):
    """MoE's spgemm impl on a mesh raises naming its ROADMAP.md item; the
    ssm, audio and vlm families build and run a step (finite metrics,
    bytes per rank equal to ``step_bytes``; their parity is held in
    ``tests/test_torch_sharded_{ssm,audio,vlm}.py``)."""
    cfg = get_arch(arch).reduced()
    shape = ShapeConfig("train", SEQ, BATCH, "train")
    mesh = _mesh((2, 2))
    if item is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="spgemm"))
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            ST.build_train_step(cfg, shape, device="cpu", mesh=mesh)
        return
    opt = AdamWConfig(lr=LR)
    options = ST.StepOptions(loss_chunk=CHUNK)
    step = ST.build_train_step(cfg, shape, opt=opt, options=options,
                               device="cpu", mesh=mesh)
    p, s = ST.init_sharded(cfg, mesh, T.init_params(cfg, 0, device="cpu"),
                           opt, options)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                      global_batch=BATCH, seed=0))
    TR.reset_bytes()
    _, _, m = step(p, s, make_global_batch(data, 0, mesh))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert TR.bytes_moved() == ST.step_bytes(cfg, mesh, shape, options, opt,
                                             frames=False)


def test_sharded_step_rejects_what_it_cannot_split():
    cfg = get_arch("olmo-1b").reduced()
    with pytest.raises(ValueError, match="microbatches"):
        ST.build_train_step(cfg, ShapeConfig("train", SEQ, 6, "train"),
                            options=ST.StepOptions(microbatch=2),
                            device="cpu", mesh=_mesh((2, 2)))
    with pytest.raises(ValueError, match="seq_parallel"):
        ST.build_train_step(cfg, ShapeConfig("train", 15, BATCH, "train"),
                            options=ST.StepOptions(seq_parallel=True),
                            device="cpu", mesh=_mesh((2, 2)))
    with pytest.raises(ValueError, match="mesh axes"):
        ST.build_train_step(cfg, ShapeConfig("train", SEQ, BATCH, "train"),
                            device="cpu",
                            mesh=make_mesh((2, 2), ("r", "c"), "cpu"))


def test_bytes_count_follows_the_options():
    """The count from the specs moves as it must: sequence parallelism
    trades each psum for a psum-scatter and an all-gather of the same
    total, bf16 partials halve the layers' reductions, and remat none
    drops the recompute's gathers."""
    cfg, mesh = get_arch("olmo-1b").reduced(), _mesh((2, 2))
    shape = ShapeConfig("train", SEQ, BATCH, "train")
    base = ST.step_bytes(cfg, mesh, shape, ST.StepOptions(remat="full"))
    none = ST.step_bytes(cfg, mesh, shape, ST.StepOptions(remat="none"))
    bf16 = ST.step_bytes(cfg, mesh, shape, ST.StepOptions(
        remat="full", bf16_reduce=True))
    assert none < base and bf16 < base
    assert np.isclose(ST.step_bytes(cfg, _mesh((1, 1)), shape), 0.0)
