"""The comparisons that decide ``correct``, against the plain references.

A served model: the reference runs once over each checked prompt with the
tokens the program served after it, and each served token is judged by
the gap by which the reference's logit for it lies below the reference's
best at that position (0 where they agree).  Valid for greedy tokens
only, which every mix serves.  A mix names the statistics it compares:
the mean gap over every judged token, or its 75th percentile; the
largest of the requests' mean gaps (``gap_session_max``); over the
engine's slots, the largest of each slot's median gap
(``gap_slot_max``), so that a fault in one slot shows; where the
program's logits are kept, also the median over requests of each
request's mean |program - reference| over the vocabulary.  (The widest
gap is reported, not compared: a bfloat16 router at random init flips
near-ties, and a flipped choice moves its token's logits about as far as
a step down in precision moves every token's.)

The control of a served model puts the reference in the program's place
one precision step down (float8 e4m3 for bfloat16) and reads, at the same
positions, the gap of the token that the lower precision puts first.

A density matrix: the program's P against the dense float64 reference's,
entry by entry, and its trace against the count of eigenvalues below mu.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import moe_lm


def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return prev


def _restore(prev) -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        prev


def _sequences(prompts, served, device) -> tuple[torch.Tensor, int, int]:
    """(tokens (B, P + n - 1), P, n): each prompt (all of one length)
    with all but the last of its served tokens, the inputs whose
    next-token logits judge them."""
    p = len(prompts[0])
    n = len(served[0])
    rows = [np.concatenate([np.asarray(pr, np.int64),
                            np.asarray(sv[:-1], np.int64)])
            for pr, sv in zip(prompts, served)]
    return torch.from_numpy(np.stack(rows)).to(device), p, n


@torch.no_grad()
def logit_gaps(cfg: dict, params: dict, prompts: list, served: list, *,
               device, batch: int = 4, control: bool = False,
               program_logits: list | None = None,
               slots: list | None = None) -> dict:
    """The widest gap over every served token of the given requests (all
    served lists of one length; the reference runs them in batches of one
    prompt length), and the statistics above; ``slots`` names each
    request's slot.  With
    ``control`` the tokens judged are those the float8 reference puts
    first, not the served ones.  With ``program_logits`` (per request, the
    (n, V) logits the program sampled its served tokens from) also the
    median over requests of the mean |program - reference| (under
    ``control`` of |float8 reference - reference|)."""
    prev = _no_tf32()
    per_req: list = [None] * len(prompts)  # each request's gaps
    errs: list = [None] * len(prompts)  # mean |program - reference|
    off_vocab = 0
    by_len: dict = {}
    for i, pr in enumerate(prompts):
        by_len.setdefault(len(pr), []).append(i)
    chunks = [ids[j:j + batch] for ids in by_len.values()
              for j in range(0, len(ids), batch)]
    try:
        for ids in chunks:
            pr, sv = [prompts[i] for i in ids], [served[i] for i in ids]
            toks, p, n = _sequences(pr, sv, device)
            hid = moe_lm.final_hidden(cfg, params, toks)[:, p - 1:p - 1 + n]
            if control:
                hq = moe_lm.final_hidden(cfg, params, toks, quant="fp8")
                hq = hq[:, p - 1:p - 1 + n]
            for j, i in enumerate(ids):
                ref = moe_lm.logits(params, hid[j])  # (n, V)
                if control:
                    low = moe_lm.logits(params, hq[j], quant="fp8")
                    pick = low.argmax(-1)
                    if program_logits is not None:
                        errs[i] = float((low - ref).abs().mean())
                else:
                    if program_logits is not None:
                        pl = program_logits[i].to(device).float()
                        errs[i] = float((pl - ref).abs().mean())
                    pick = torch.as_tensor(np.asarray(sv[j], np.int64),
                                           device=device)
                    bad = (pick < 0) | (pick >= ref.shape[1])
                    off_vocab += int(bad.sum())
                    pick = torch.clamp(pick, 0, ref.shape[1] - 1)
                gap = ref.max(-1).values - ref.gather(1, pick[:, None])[:, 0]
                per_req[i] = gap.tolist()
    finally:
        _restore(prev)
    gaps = [x for r in per_req for x in r]
    errs = [x for x in errs if x is not None]
    g = np.asarray(gaps)
    e = np.asarray(errs if errs else [0.0])
    slots = list(range(len(per_req))) if slots is None else list(slots)
    by_slot: dict = {}
    for s, r in zip(slots, per_req):
        by_slot.setdefault(s, []).extend(r)
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean()),
            "logit_gap_p75": float(np.percentile(g, 75)),
            "gap_session_max": max(float(np.mean(r)) for r in per_req),
            "gap_slot_max": max(float(np.median(v))
                                for v in by_slot.values()),
            "logit_err_median": float(np.median(e)),
            "judged": int(g.size), "off_vocab": off_vocab,
            "gaps": gaps, "errs": errs}
