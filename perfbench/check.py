"""How ``correct`` is decided: after the window, a sample of the requests
the program served, drawn from the seed and holding the one with the most
served tokens, is run once through the plain reference over its prompt and
served tokens. At each served position the gap is how far the served
token's logit lies below the reference's best; the served tokens are
greedy, so a sound program serves the reference's best or a token within
rounding of it. ``gaps`` gives the widest gap, the mean, the 99th
percentile and the shares of positions over 0.1, 0.2 and 0.3; each cell's
file names the ones it compares and their limits (``check.limits``).

The control (``control=True``) puts the reference in the program's place
at the step below the configuration's bfloat16, float8 products: at each of
the same positions it reads the gap of the token float8 puts first.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import decoder


def sample(served, seed: int, requests: int, tokens: int) -> list:
    """Indices into ``served`` (a list of (prompt ids, served ids, done)):
    the request with the most served tokens (a finished one if any
    finished), then others drawn from the seed, finished ones first, until
    ``requests`` of them or ``tokens`` served tokens are in."""
    have = [i for i, (_, out, _) in enumerate(served) if out]
    if not have:
        return []
    done = [i for i in have if served[i][2]]
    pool = done or have
    first = max(pool, key=lambda i: (len(served[i][1]), -i))
    rng = np.random.default_rng([seed & (2**63 - 1), 3])
    rest = [i for i in done if i != first]
    rest = list(rng.permutation(rest)) + list(rng.permutation(
        [i for i in have if i not in done and i != first]))
    pick, n = [first], len(served[first][1])
    for i in rest:
        if len(pick) >= requests or n >= tokens:
            break
        pick.append(int(i))
        n += len(served[i][1])
    return pick


def _seqs(served, pick):
    """(ids, first, n): the sequence the reference reads (prompt and every
    served token but the last), the position of the prompt's last token,
    and the number of served tokens."""
    out = []
    for i in pick:
        prompt, toks, _ = served[i]
        out.append((list(prompt) + list(toks[:-1]), len(prompt) - 1,
                    len(toks)))
    return out


def gaps(params, cfg: dict, served, pick, control: bool = False) -> dict:
    """The gaps of the served tokens (and, with ``control``, of float8's
    first tokens) below the reference's best, over the sample: the widest
    and the mean over every served position."""
    seqs = _seqs(served, pick)
    ref = decoder.logits_at(params, cfg, seqs)
    low = decoder.logits_at(params, cfg, seqs, quantize=True) \
        if control else [None] * len(seqs)
    mine, theirs = [], []
    for r, lo, i in zip(ref, low, pick):
        toks = torch.as_tensor(served[i][1], device=r.device)
        best = r.max(-1).values
        mine.append(best - r.gather(1, toks[:, None])[:, 0])
        if lo is not None:
            theirs.append(best - r.gather(1, lo.argmax(-1)[:, None])[:, 0])
    out = {"served_tokens": sum(n for _, _, n in seqs),
           "sampled_requests": len(seqs), **_stats(mine, "")}
    if control:
        out.update(_stats(theirs, "control_"))
    return out


def _stats(gap_list, prefix: str) -> dict:
    g = torch.cat(gap_list).double()
    out = {f"{prefix}max_logit_gap": float(g.max()),
           f"{prefix}mean_logit_gap": float(g.mean()),
           f"{prefix}p99_logit_gap": float(torch.quantile(g, 0.99)),
           f"{prefix}not_best_share": float((g > 0).double().mean())}
    for tau in (0.1, 0.2, 0.3):
        out[f"{prefix}share_over_{tau}"] = float((g > tau).double().mean())
    return out
