"""Plan layer, local part — the torch twin of the pattern and chain caches
of ``repro/core/plan.py``.

``get_product_stacks`` caches compacted product lists per sparsity-pattern
signature, so a repeated pattern skips compaction; ``get_chain_program``
caches the fused sign-iteration sweep per key.  The reference's
jit-program cache (``get_local_compiled``) has no twin: PyTorch runs
eagerly.  The schedule layer (``plan_multiply`` and the engines' plans)
arrives with the distributed slice.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import asdict, dataclass

from repro_torch.kernels.stacks import (
    bucket_capacity,
    compact_pair_mask,
    pattern_signature,
    product_count,
)


@dataclass
class CacheStats:
    pattern_hits: int = 0  # compacted product-list reuse (same signature)
    pattern_misses: int = 0
    chain_hits: int = 0  # fused sweep reuse (sign iteration)
    chain_misses: int = 0
    evictions: int = 0


_CACHE_MAXSIZE = 128
# a product list of a full 512^3 cube holds 3.8 GB of index arrays, so the
# pattern cache is bounded by bytes as well as by entries
_PATTERN_CACHE_MAX_BYTES = 4 * 2**30
_pattern_cache: OrderedDict[bytes, tuple] = OrderedDict()
_chain_cache: OrderedDict[tuple, object] = OrderedDict()
_stats = CacheStats()


def cache_stats() -> dict:
    """Pattern / chain cache counters."""
    return asdict(_stats)


def clear_cache() -> None:
    """Drop every plan-layer cache and zero every counter."""
    global _stats
    _pattern_cache.clear()
    _chain_cache.clear()
    _stats = CacheStats()


def _stacks_bytes(entry) -> int:
    stacks, _n = entry
    return sum(t.numel() * t.element_size() for t in stacks)


def get_product_stacks(pair_ok):
    """Compacted product list of a (ni, nk, nj) filter cube.

    Returns ``(stacks, n_products)``: a ``ProductStacks`` on the cube's
    device, padded to the power-of-two bucket of the surviving count and
    LRU-cached on the pattern signature.  A repeated pattern is a cache
    hit: no compaction.
    """
    sig = pattern_signature(pair_ok)
    hit = _pattern_cache.get(sig)
    if hit is not None:
        _stats.pattern_hits += 1
        _pattern_cache.move_to_end(sig)
        return hit
    _stats.pattern_misses += 1
    n = product_count(pair_ok)
    entry = (compact_pair_mask(pair_ok, capacity=bucket_capacity(n)), n)
    _pattern_cache[sig] = entry
    while len(_pattern_cache) > 1 and (
        len(_pattern_cache) > _CACHE_MAXSIZE
        or sum(map(_stacks_bytes, _pattern_cache.values()))
        > _PATTERN_CACHE_MAX_BYTES
    ):
        _pattern_cache.popitem(last=False)
        _stats.evictions += 1
    return entry


def get_chain_program(key: tuple, make_program):
    """Fused chain-step program (a whole sign-iteration sweep), cached per
    key and counted by ``chain_hits`` / ``chain_misses``."""
    key = ("chain",) + tuple(key)
    prog = _chain_cache.get(key)
    if prog is not None:
        _stats.chain_hits += 1
        _chain_cache.move_to_end(key)
        return prog
    _stats.chain_misses += 1
    prog = make_program()
    _chain_cache[key] = prog
    if len(_chain_cache) > _CACHE_MAXSIZE:
        _chain_cache.popitem(last=False)
        _stats.evictions += 1
    return prog
