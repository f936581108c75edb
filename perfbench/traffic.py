"""The one traffic generator. A mix is a data file, ``traffic/<mix>.json``,
of parameters: the loop (``open`` on a schedule, ``closed`` over clients),
the arrival process, the prompt and output length distributions, and the
``shape_seed`` that fixes the sample of sizes and gaps.

Every seed of a cell serves the same requests at the same times: the sizes
and the arrival gaps are drawn once, in order, from ``shape_seed``, as a
trace is replayed; ``--seed`` draws the token ids (and, in the harness, the
weights). So runs with different seeds do the same work at the same
moments, and spread only by the program's own timing.

The shapes are frozen copies of the BurstGPT-like generators the program
ships (``repro_torch/data/burstgpt.py``: ``bursty_poisson``'s Gamma-renewal
arrivals at a coefficient of variation, lognormal prompts, Gamma outputs).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Item:
    """One request as the traffic makes it: its sizes and, in an open loop,
    its due time."""
    prompt_len: int
    output_len: int
    due: float = 0.0


def _lengths(rng, spec: dict, n: int) -> np.ndarray:
    lo, hi = spec["min"], spec["max"]
    kind = spec["dist"]
    if kind == "lognormal":
        x = rng.lognormal(spec["mu"], spec["sigma"], size=n)
    elif kind == "gamma":
        x = rng.gamma(spec["shape"], spec["scale"], size=n)
    elif kind == "uniform":
        return rng.integers(lo, hi + 1, size=n)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(x, lo, hi).astype(np.int64)


def _gaps(rng, arrivals: dict, n: int, seconds: float) -> np.ndarray:
    """n inter-arrival gaps of a Gamma renewal process at the mix's
    coefficient of variation, scaled so that the n-th arrival falls at
    ``seconds * n / (n + 1)``: the whole sample is due inside the window,
    whatever its order."""
    if arrivals["process"] != "gamma":
        raise ValueError(f"unknown arrival process {arrivals['process']!r}")
    shape = 1.0 / arrivals["cv"] ** 2
    g = rng.gamma(shape, 1.0, size=n)
    return g * (seconds * n / (n + 1) / g.sum())


def _order(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**63 - 1), salt])


def open_schedule(mix: dict, rate: float, seconds: float,
                  lead: float = 0.0) -> list[Item]:
    """An open loop: round(rate * (lead + seconds)) requests in order of
    their due times, all inside [-lead, seconds): those due before 0 are
    the lead-in, served before the window opens so that it opens on a
    loaded engine."""
    n = max(1, round(rate * (lead + seconds)))
    shape = np.random.default_rng(mix["shape_seed"])
    gaps = _gaps(shape, mix["arrivals"], n, lead + seconds)
    plen = _lengths(shape, mix["prompt"], n)
    olen = _lengths(shape, mix["output"], n)
    due = np.cumsum(gaps) - lead
    return [Item(int(plen[i]), int(olen[i]), float(due[i])) for i in range(n)]


def closed_plan(mix: dict, clients: int,
                rounds: int) -> tuple[list[Item], list[Item]]:
    """A closed loop, met in its steady state: the clients' first requests,
    one each, and the requests sent after them, in order, each by the next
    client whose request completes. Each first request is one already
    under way, a share (i + 1/2) / clients of its output left (the shares
    paired with the sizes by the shape seed): the output it has already
    served is part of its context, and what is left is its output."""
    shape = np.random.default_rng(mix["shape_seed"])
    n = clients * rounds
    plen = _lengths(shape, mix["prompt"], n)
    olen = _lengths(shape, mix["output"], n)
    left = (shape.permutation(clients) + 0.5) / clients
    first = []
    for c in range(clients):
        rem = max(1, int(np.ceil(left[c] * olen[c])))
        first.append(Item(int(plen[c] + olen[c] - rem), rem))
    rest = [Item(int(plen[k]), int(olen[k])) for k in range(clients, n)]
    return first, rest


def sizes(mix: dict, params: dict, seconds: float) -> list[tuple[int, int]]:
    """Every (prompt, output) size the cell's window can meet."""
    if mix["loop"] == "open":
        items = open_schedule(mix, params["rate_per_s"], seconds,
                              params["lead_in_s"])
    else:
        first, rest = closed_plan(mix, params["clients"], params["rounds"])
        items = first + rest
    return [(i.prompt_len, i.output_len) for i in items]


def tokens(seed: int, lengths, vocab: int, salt: int = 2) -> list[list[int]]:
    """Prompt token ids from the seed, uniform over [1, vocab); another
    ``salt`` gives another stream (the warm-up's)."""
    rng = _order(seed, salt)
    return [rng.integers(1, vocab, size=n).tolist() for n in lengths]
