"""The vlm family on a mesh of ranks (``parallel/runtime.py``):
pixtral-12b reduced (f32, four heads over two kv heads of 32, eight patch
embeddings in front of the tokens) on meshes 2 x 2, 2 x 1 x 2, 1 x 2
and 1 x 4 (two kv heads do not divide four model ranks: attention runs
whole with GQA, its weights gathered, the cache's sequence over
``model``, qwen1.5-4b's path at full width).

The patches replace the prefix rows after the vocab-parallel embedding's
reduction (added before it, on every model rank, they would count m
times); under ``seq_parallel`` each rank places the part of the prefix
its chunk of positions holds, and a prefix of twelve rows on 1 x 4 ranks
(chunks of eight) straddles two ranks.  Training: three sharded steps
against the port's one-device step with the same patches
(``tests/test_torch_sharded_step.py``'s ``_run_case``; bytes per rank
equal to ``step_bytes``).  Serving: a prefill with the patches and three
decode steps against the one-device steps within 1e-4.
"""
from __future__ import annotations

import dataclasses

import pytest
import test_torch_serve_step as SV
import test_torch_sharded_step as SS
import torch

from repro_torch.configs import get_arch
from repro_torch.optim.tree import leaves


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(n_patches=8):
    return dataclasses.replace(get_arch("pixtral-12b").reduced(),
                               n_patches=n_patches)


CASES = [
    ("pixtral-12b", (2, 2), dict(remat="full")),
    ("pixtral-12b", (2, 1, 2), dict(remat="dots")),
    ("pixtral-12b", (1, 2), dict(remat="none", seq_parallel=True)),
    ("pixtral-12b", (1, 4), dict(remat="full", seq_parallel=True)),
]


@pytest.mark.parametrize("arch,dims,opts", CASES,
                         ids=[SS._id(c) for c in CASES])
def test_sharded_step_matches_one_device(arch, dims, opts, monkeypatch):
    n = 12 if dims == (1, 4) else 8  # across two ranks' chunks there
    SS._run_case(_cfg(n), dims, opts, monkeypatch,
                 embeds={"patch_embeds": n})


def test_patches_once_not_per_model_rank(monkeypatch):
    """Patches placed on every model rank's part of the vocab-parallel
    embedding, before its reduction (so summed m times): the step
    misses."""
    import torch.nn.functional as F

    from repro_torch.parallel import runtime as RT

    def early(self, tok, tokens, patches=None):
        out = []
        for r, (w, t) in enumerate(zip(tok, tokens)):
            loc = t - self.mi[r] * w.shape[0]
            inside = (loc >= 0) & (loc < w.shape[0])
            e = (F.embedding(torch.where(inside, loc, 0), w)
                 * inside[..., None].to(w.dtype))
            n = patches[r].shape[1]
            out.append(torch.cat([patches[r].to(e.dtype), e[:, n:]], 1))
        return self._run(self.btd_op(self.embed_tp), out)

    monkeypatch.setattr(RT.DecoderRuntime, "_inputs", early)
    with pytest.raises(AssertionError):
        SS._run_case(_cfg(), (1, 2), dict(remat="none"), monkeypatch,
                     embeds={"patch_embeds": 8})


@pytest.mark.parametrize("dims,names", SV.MESHES + [
    ((1, 4), ("data", "model"))], ids=["d2m2", "p2d1m2", "m4-seq"])
def test_sharded_serving_matches_one_device(dims, names):
    c_spec = SV._sharded_vs_one_device(_cfg(), dims, names,
                                       embeds={"patch_embeds": 8})
    k_spec = tuple(leaves(c_spec)[0])
    assert k_spec[1:3] == ((None, "model") if dims[-1] == 4
                           else ("model", None))
