"""The port's MoE family against the JAX package on the same weights and
inputs: ``moe_block`` in its serving and training capacities (with and
without drops, and with tied router scores), whole prefill / decode logits,
the paged decode step and the engine, on reduced configurations."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.engine import paged_model as jpaged  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.config import TPU_V5E  # noqa: E402
from repro_torch.engine import paged_model as tpaged  # noqa: E402
from repro_torch.engine.engine import LLMEngine  # noqa: E402
from repro_torch.engine.executor import RealExecutor  # noqa: E402
from repro_torch.engine.request import Request, SamplingParams  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

# f32 on both sides: |port - jax| <= 1e-5 + 1e-5 * |jax|
TOL = dict(rtol=1e-5, atol=1e-5)
# the JAX side compiled once per shape: op by op, each decode step retraces
# its layer scan (most of a second)
_jprefill = jax.jit(japi.prefill_fn, static_argnums=1)
_jdecode = jax.jit(japi.decode_fn, static_argnums=1)
_jmoe_block = jax.jit(jmoe.moe_block, static_argnums=(1, 3))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _moe_weights(cfg, rng, shared=False):
    """One layer's MoE leaves at the JAX fan-in scales, as numpy f32."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def w(shape, fan_in, scale=1.0):
        return (rng.normal(size=shape) * scale * fan_in ** -0.5).astype(
            np.float32)

    p = {"router": w((d, e), d, 0.1), "w_gate": w((e, d, f), d),
         "w_up": w((e, d, f), d), "w_down": w((e, f, d), f)}
    if shared:
        p["shared"] = {"w_gate": w((d, f), d), "w_up": w((d, f), d),
                       "w_down": w((f, d), f)}
    return p


def _tree(p):
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in p.items()}


def _cfgs(name):
    return jconfigs.get(name).reduced(), tconfigs.get(name).reduced()


def _routing(cfg, p, x):
    """The port's expert choice (N, k) and the most entries any expert got."""
    xf = _t(x).reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ _t(p["router"]), dim=-1)
    _, top_i = tmoe.top_k(probs, cfg.num_experts_per_tok)
    return top_i, int(torch.bincount(top_i.reshape(-1)).max())


@pytest.mark.parametrize("case", ["serve_dropless", "serve_overflow",
                                  "train_cf125", "shared_expert"])
def test_moe_block_matches_jax(case, rng):
    """Serving at n <= 64 (cap = n), serving at n > 64 with a router skewed
    so that expert 0 overflows its capacity, the training capacity 1.25
    (drops too), and kimi-k2's shared expert."""
    name = "kimi-k2-1t-a32b" if case == "shared_expert" else \
        "qwen3-moe-30b-a3b"
    jcfg, tcfg = _cfgs(name)
    p = _moe_weights(jcfg, rng, shared=case == "shared_expert")
    b, t = (2, 48) if case == "serve_overflow" else (2, 8)
    x = (rng.normal(size=(b, t, jcfg.d_model)) * 0.3).astype(np.float32)
    cf = 1.25 if case == "train_cf125" else None
    if case == "serve_overflow":
        x[..., 0] = 1.0
        p["router"][0, 0] = 20.0     # every token's first choice: expert 0
    jy, jaux = _jmoe_block(p, jcfg, jnp.asarray(x), cf)
    ty, taux = tmoe.moe_block(_tree(p), tcfg, _t(x), capacity_factor=cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    n, k, e = b * t, jcfg.num_experts_per_tok, jcfg.num_experts
    cap = tmoe.capacity(n, k, e, cf)
    _, most = _routing(tcfg, p, x)
    if case in ("serve_overflow", "train_cf125"):
        assert cap < n and most > cap, "no entry was dropped"
    else:
        assert cap == n and most <= cap


def test_moe_block_all_ties_match_jax(rng):
    """A zero router ties every expert: the chosen experts are those of
    ``lax.top_k`` (the lowest ids), and with n > 64 the capacity drops the
    same entries, so the outputs agree."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b")
    p = _moe_weights(jcfg, rng)
    p["router"][:] = 0.0
    x = (rng.normal(size=(1, 80, jcfg.d_model)) * 0.3).astype(np.float32)
    top_i, most = _routing(tcfg, p, x)
    probs = jnp.full((80, jcfg.num_experts), 1.0 / jcfg.num_experts)
    _, j_top = lax.top_k(probs, jcfg.num_experts_per_tok)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(j_top))
    assert most > tmoe.capacity(80, jcfg.num_experts_per_tok,
                                jcfg.num_experts, None)
    jy, _ = _jmoe_block(p, jcfg, jnp.asarray(x), None)
    ty, _ = tmoe.moe_block(_tree(p), tcfg, _t(x), capacity_factor=None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_moe_dropless_serving_is_exact(rng):
    """Twin of the JAX test of the same name: the serving block (cap = n)
    gives every token all its k experts, against a loop over tokens and
    experts."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b")
    p = _moe_weights(jcfg, rng)
    x = (rng.normal(size=(2, 8, jcfg.d_model)) * 0.3).astype(np.float32)
    y, _ = tmoe.moe_block(_tree(p), tcfg, _t(x), capacity_factor=None)
    xf = x.reshape(-1, jcfg.d_model)
    logits = xf @ p["router"]
    z = np.exp(logits - logits.max(-1, keepdims=True))
    probs = z / z.sum(-1, keepdims=True)
    out = np.zeros_like(xf)
    for i, row in enumerate(xf):
        top = np.argsort(-probs[i], kind="stable")[:jcfg.num_experts_per_tok]
        w = probs[i][top] / probs[i][top].sum()
        for j, e in enumerate(top):
            g = row @ p["w_gate"][e]
            h = g / (1 + np.exp(-g)) * (row @ p["w_up"][e])
            out[i] += w[j] * (h @ p["w_down"][e])
    np.testing.assert_allclose(y.numpy().reshape(-1, jcfg.d_model), out,
                               **TOL)


@functools.lru_cache(maxsize=None)
def _setup(name, seed=7):
    jcfg, tcfg = _cfgs(name)
    params, _ = japi.init_params(jcfg, jax.random.key(seed))
    tree = tparams.from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tcfg, tree


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_moe_prefill_and_decode_match_jax(name, rng):
    """Whole-model logits: prefill over 2 x 13 tokens, then 3 decode steps
    against the dense cache. kimi-k2 carries the shared expert."""
    jcfg, jp, tcfg, tp = _setup(name)
    t, n_new = 13, 3
    toks = rng.integers(1, jcfg.vocab_size, size=(2, t)).astype(np.int32)
    jl, jc = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = tapi.prefill_fn(tp, tcfg, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jc = japi.pad_cache(jcfg, jc, t + n_new)
    tc = tapi.pad_cache(tcfg, tc, t + n_new)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for i in range(n_new):
        pos = np.full((2,), t + i, np.int32)
        jl, jc = _jdecode(jp, jcfg, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl, tc = tapi.decode_fn(tp, tcfg, _t(nxt).long(), tc, _t(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)


def test_moe_paged_decode_matches_jax(rng):
    """write_prefill, then one paged decode_step through the MoE branch, on
    identical pools and tables: logits and the updated pool agree."""
    jcfg, jp, tcfg, tp = _setup("qwen3-moe-30b-a3b")
    bs, nb, mb = 8, 12, 4
    jpool = jpaged.init_pool(jcfg, nb, bs)
    tpool = tpaged.init_pool(tcfg, nb, bs, device="cpu")
    tables = [[3, 0, 7], [5, 9]]           # block 0 is an ordinary block
    lens = [19, 9]
    for table, n in zip(tables, lens):
        toks = rng.integers(1, jcfg.vocab_size, size=(1, n)).astype(np.int32)
        _, jc = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
        _, tc = tapi.prefill_fn(tp, tcfg, {"tokens": _t(toks).long()})
        jpool = jpaged.write_prefill(jpool, jc, jnp.asarray(table, jnp.int32),
                                     bs)
        tpaged.write_prefill(tpool, tc, torch.tensor(table), bs)
    bt = np.zeros((2, mb), np.int32)
    for i, table in enumerate(tables):
        bt[i, :len(table)] = table
    toks = np.array([11, 22], np.int32)
    pos = np.array(lens, np.int32)
    jl, jpool = jpaged.decode_step(jp, jcfg, jnp.asarray(toks),
                                   jnp.asarray(pos), jpool, jnp.asarray(bt))
    tl, tpool = tpaged.decode_step(tp, tcfg, _t(toks).long(), _t(pos).long(),
                                   tpool, _t(bt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(),
                                   np.asarray(jpool[name]), **TOL)


def _oracle_generate(cfg, params, prompt, n_new):
    """The JAX dense-cache oracle of tests/test_engine.py, for any family
    of the paged path."""
    toks = jnp.asarray(prompt, jnp.int32)[None]
    logits, cache = _jprefill(params, cfg, {"tokens": toks})
    cache = japi.pad_cache(cfg, cache, len(prompt) + n_new + 8)
    out = [int(jnp.argmax(logits[0]))]
    for i in range(n_new - 1):
        pos = jnp.asarray([len(prompt) + i], jnp.int32)
        logits, cache = _jdecode(
            params, cfg, jnp.asarray([out[-1]], jnp.int32), cache, pos)
        out.append(int(jnp.argmax(logits[0])))
    return out


def test_moe_paged_engine_matches_oracle(rng):
    """The port's RealExecutor on the CPU serves reduced qwen3-moe to the
    JAX oracle's greedy tokens. The 90-token prompt prefills with n > 64,
    where the capacity is below n; chunked prefill (32-token chunks) and
    mixed prefill + decode steps run too."""
    jcfg, jp, tcfg, tp = _setup("qwen3-moe-30b-a3b")
    prompts = [list(rng.integers(1, jcfg.vocab_size, size=n))
               for n in (11, 90)]
    oracle = [_oracle_generate(jcfg, jp, p, 6) for p in prompts]
    ex = RealExecutor(tcfg, tp, num_blocks=64, block_size=16, hw=TPU_V5E,
                      max_model_len=256, device="cpu")
    eng = LLMEngine(tcfg, ex, num_blocks=64, block_size=16, max_num_seqs=8,
                    max_prefill_tokens=32, max_model_len=256)
    reqs = [Request(prompt_tokens=list(p), sampling=SamplingParams(
        temperature=0.0, max_new_tokens=6)) for p in prompts]
    now = 0.0
    for r in reqs:
        eng.add_request(r, now)
    while eng.has_work():
        now += max(eng.step(now).elapsed, 1e-4)
    assert [r.output_tokens for r in reqs] == oracle
    assert ex.prefill_computes == 2 and ex.decode_steps > 0
    eng.allocator.check_invariants()


def test_executor_refuses_vlm():
    """The reference's executor passes no patch embeddings, so its vlm
    prefill fails; the port's says why before it starts."""
    cfg = tconfigs.get("pixtral-12b").reduced()
    params = tapi.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="patch embeddings"):
        RealExecutor(cfg, params, num_blocks=8, block_size=4, hw=TPU_V5E,
                     device="cpu")
