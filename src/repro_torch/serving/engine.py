"""Batched serving engine: prefill + decode against the model's cache (K/V
rows of the attention layers, carried states of the recurrent ones).

The torch twin of ``repro/serving/engine.py``.  Slot-based continuous
batching: the engine owns ``batch`` slots; requests occupy a slot through
prefill and greedy/temperature decode, and finished slots are refilled
from the queue without draining the batch (the decode step always runs the
full batch — finished slots just carry padding).

Two entry points:

* ``generate`` — one fully-batched round: prompts in (left-padded to the
  longest, the pads attended as in the reference), continuations out;
* ``serve`` — drain a request queue through the slots: eos / length
  exhaustion frees a slot, the next queued request prefills into it, and
  decode proceeds with per-slot cache positions (``decode_step`` takes a
  (B,) position vector).  Per-step wall times, occupancy and refill
  counts land in ``last_serve_stats``.

A refill runs one full-batch prefill into a fresh cache, the slots it
does not fill padded with zeros, and copies the refilled slots' rows into
the live cache, as the reference does.  (Prefilling only the refilled
rows would save work, but a request's numbers would then depend on how
many requests refill with it: cuBLAS picks its GEMM kernel by the row
count, and in bf16 two kernels round differently.  On the H100,
rwkv6-7b's first refilled request, prefilled beside 3 others, parted
from itself generated alone after 12 greedy tokens.)  A row is every
leaf's slice on the batch dim: K/V rows, and a mamba layer's conv tail
and SSM state or an rwkv6 layer's shift tails and wkv state, so a
refilled slot starts from its own prompt's state (a fresh prefill's, from
zero), never from the previous request's.

Every prefill goes through ``models.attention.chunked_attention``, so on a
CUDA device through the flash kernel.

Serving dispatch (DESIGN.md §11): ``set_dispatch`` installs a
``models.moe.DispatchSpec`` — a warmed pattern envelope plus the decision
resolved for its bucket — and every prefill and decode step runs under
``dispatch_scope`` with it, so the MoE ``spgemm`` impl takes the spec's
backend and capacity (on a card, the block-SpGEMM kernel).  PyTorch has
no jitted programs to cache per spec; ``_spec_key`` keeps the reference's
key (envelope signature, backend, capacity), and ``last_serve_stats``
records the key that served a round.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.models import moe as MoE
from repro_torch.models import transformer as T
from repro_torch.obs import span


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 == greedy
    eos_token: int | None = None
    seed: int = 0


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    arrival: int = 0  # decode-step index at which the request exists
    out: list[int] = field(default_factory=list)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ServingEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        batch: int,
        max_len: int,
        gen: GenerationConfig = GenerationConfig(),
    ):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.gen = gen
        self.device = params["embed"]["tok"].device
        self._gen = torch.Generator(device=self.device).manual_seed(gen.seed)
        self._dispatch: MoE.DispatchSpec | None = None
        self.last_serve_stats: dict = {}

    # -- dispatch spec (serving path, DESIGN.md §11) -----------------------
    def set_dispatch(self, spec: MoE.DispatchSpec | None) -> None:
        """Install the ambient dispatch decision for the MoE spgemm impl
        (None: the impl's cold path)."""
        self._dispatch = spec

    @property
    def dispatch_spec(self) -> MoE.DispatchSpec | None:
        """The installed dispatch decision (None: the impl's cold path)."""
        return self._dispatch

    def _spec_key(self) -> tuple:
        """The reference's program key of the installed spec: (envelope
        signature, backend, capacity), or (None,) without one."""
        s = self._dispatch
        if s is None:
            return (None,)
        sig = s.envelope.signature if s.envelope is not None else None
        return (sig, s.backend, s.stack_capacity)

    def _prefill(self, toks: torch.Tensor, cache):
        with MoE.dispatch_scope(self._dispatch):
            return T.prefill(self.cfg, self.params, toks, cache)

    def _decode(self, toks: torch.Tensor, cache, position):
        with MoE.dispatch_scope(self._dispatch):
            return T.decode_step(self.cfg, self.params, toks, cache,
                                 position)

    # -- sampling ----------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        last = logits[:, -1]
        if self.gen.temperature <= 0.0:
            return torch.argmax(last, dim=-1)
        probs = torch.softmax(last.float() / self.gen.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(toks).to(self.device, torch.long)

    # -- one fully-batched generation round --------------------------------
    def generate(self, prompts: list[np.ndarray]) -> list[list[int]]:
        """Generate for up to ``batch`` prompts (left-padded to equal)."""
        if len(prompts) > self.batch:
            raise ValueError(f"{len(prompts)} prompts for {self.batch} slots")
        plen = max(len(p) for p in prompts)
        toks = np.zeros((self.batch, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p  # left-pad

        cache = T.init_cache(self.cfg, self.batch, self.max_len,
                             device=self.device)
        logits, cache = self._prefill(self._tokens(toks), cache)
        next_tok = self._sample(logits)

        outs: list[list[int]] = [[] for _ in range(self.batch)]
        done = np.zeros(self.batch, bool)
        position = plen
        for _ in range(self.gen.max_new_tokens):
            for i, t in enumerate(next_tok.tolist()):
                if i < len(prompts) and not done[i]:
                    outs[i].append(t)
                    if self.gen.eos_token is not None and t == self.gen.eos_token:
                        done[i] = True
            if done[: len(prompts)].all():
                break
            logits, cache = self._decode(next_tok[:, None], cache, position)
            next_tok = self._sample(logits)
            position += 1
        return outs[: len(prompts)]

    # -- continuous batching -----------------------------------------------
    def _refill(self, queue, active, cache, next_tok, pos_dev, plen,
                step: int, prefills: list):
        """Prefill queued requests into free slots and copy their rows in.

        One full-batch prefill (the other slots padded) into a fresh
        cache; the refilled slots' rows of every leaf (K/V or recurrent
        state) replace the live cache's.
        """
        free = [i for i, r in enumerate(active) if r is None]
        slots: list[int] = []
        toks = np.zeros((self.batch, plen), np.int32)
        for slot in free:
            if not queue or queue[0].arrival > step:
                break
            req = queue.popleft()
            toks[slot, plen - len(req.prompt):] = req.prompt
            active[slot] = req
            slots.append(slot)
        if not slots:
            return 0
        _sync(self.device)
        t0 = time.perf_counter()
        with span("repro.serve.refill"):
            fresh = T.init_cache(self.cfg, self.batch, self.max_len,
                                 device=self.device)
            logits, fresh = self._prefill(self._tokens(toks), fresh)
            first = self._sample(logits)
            idx = torch.tensor(slots, device=self.device)
            for live, new in zip(cache["blocks"], fresh["blocks"]):
                for name in live:
                    live[name][idx] = new[name][idx]
            next_tok[idx] = first[idx]
            pos_dev[idx] = plen
            _sync(self.device)
        prefills.append({"step": step, "slots": len(slots),
                         "wall_s": time.perf_counter() - t0})
        return len(slots)

    def serve(self, prompts: list[np.ndarray],
              arrivals: list[int] | None = None) -> list[list[int]]:
        """Drain a request queue through the ``batch`` slots.

        ``arrivals`` (optional, decode-step units, non-decreasing) holds
        request i back until that step.  Returns the generated token lists
        in request order; per-step wall times (``wall_s``, refill
        included, and ``decode_s``, the decode step alone), occupancy,
        refill counts and per-refill prefill times land in
        ``last_serve_stats``.
        """
        if arrivals is None:
            arrivals = [0] * len(prompts)
        if len(arrivals) != len(prompts):
            raise ValueError(f"{len(arrivals)} arrivals for {len(prompts)} "
                             "prompts")
        plen = max(len(p) for p in prompts)
        if plen + 1 >= self.max_len:
            raise ValueError(f"prompt length {plen} leaves no room in "
                             f"max_len {self.max_len}")
        limit = min(self.gen.max_new_tokens, self.max_len - plen - 1)

        queue = deque(
            _Request(i, np.asarray(p, np.int32), arrival=int(a))
            for i, (p, a) in enumerate(zip(prompts, arrivals))
        )
        active: list[_Request | None] = [None] * self.batch
        results: dict[int, list[int]] = {}
        cache = T.init_cache(self.cfg, self.batch, self.max_len,
                             device=self.device)
        next_tok = torch.zeros((self.batch,), dtype=torch.long,
                               device=self.device)
        pos_dev = torch.zeros((self.batch,), dtype=torch.long,
                              device=self.device)

        step = 0
        steps: list[dict] = []
        prefills: list[dict] = []
        n_refills = 0
        while queue or any(r is not None for r in active):
            t0 = time.perf_counter()
            filled = self._refill(queue, active, cache, next_tok, pos_dev,
                                  plen, step, prefills)
            n_refills += 1 if filled else 0
            occupied = [i for i, r in enumerate(active) if r is not None]
            if not occupied:
                # idle gap before the next arrival: jump the clock
                step = max(step + 1, queue[0].arrival if queue else step + 1)
                continue
            t1 = time.perf_counter()
            with span("repro.serve.decode"):
                logits, cache = self._decode(next_tok[:, None], cache,
                                             pos_dev)
                sampled = self._sample(logits)
                host_prev = next_tok.tolist()  # waits for the device
                _sync(self.device)
            t2 = time.perf_counter()
            # the token decoded THIS step is the one that was in next_tok
            for i in occupied:
                req = active[i]
                tok = host_prev[i]
                req.out.append(tok)
                eos = (self.gen.eos_token is not None
                       and tok == self.gen.eos_token)
                if eos or len(req.out) >= limit:
                    results[req.rid] = req.out
                    active[i] = None
            next_tok = sampled
            pos_dev = torch.clamp(pos_dev + 1, max=self.max_len - 1)
            steps.append({
                "step": step,
                "occupancy": len(occupied) / self.batch,
                "wall_s": t2 - t0,
                "decode_s": t2 - t1,
                "refilled": filled,
            })
            step += 1
        self.last_serve_stats = {
            "steps": steps,
            "prefills": prefills,
            "n_refills": n_refills,
            "n_requests": len(prompts),
            "spec_key": self._spec_key(),
        }
        return [results[i] for i in range(len(prompts))]
