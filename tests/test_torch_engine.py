"""The port's engine on the CPU against the JAX dense oracle: twins of the
RealExecutor tests in tests/test_engine.py, plus the paged-pool glue against
the JAX package's on identical pools and tables."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.engine import paged_model as jpaged  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.config import TPU_V5E  # noqa: E402
from repro_torch.engine import paged_model as tpaged  # noqa: E402
from repro_torch.engine.engine import LLMEngine  # noqa: E402
from repro_torch.engine.executor import RealExecutor, SimExecutor  # noqa: E402
from repro_torch.engine.request import Request, SamplingParams  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402


@pytest.fixture(scope="module")
def dense_setup():
    jcfg = jconfigs.get("qwen3-1.7b").reduced()
    params, _ = japi.init_params(jcfg, jax.random.key(7))
    tree = tparams.from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tconfigs.get("qwen3-1.7b").reduced(), tree


def oracle_generate(cfg, params, prompt, n_new):
    """The JAX dense oracle of tests/test_engine.py."""
    toks = jnp.asarray(prompt, jnp.int32)[None]
    logits, cache = japi.prefill_fn(params, cfg, {"tokens": toks})
    cache = japi.pad_cache(cfg, cache, len(prompt) + n_new + 8)
    out = [int(jnp.argmax(logits[0]))]
    for i in range(n_new - 1):
        pos = jnp.asarray([len(prompt) + i], jnp.int32)
        logits, cache = japi.decode_fn(
            params, cfg, jnp.asarray([out[-1]], jnp.int32), cache, pos)
        out.append(int(jnp.argmax(logits[0])))
    return out


def run_engine(eng, reqs, max_steps=2000):
    now = 0.0
    for r in reqs:
        eng.add_request(r, now)
    steps = 0
    while eng.has_work() and steps < max_steps:
        rep = eng.step(now)
        now += max(rep.elapsed, 1e-4)
        steps += 1
    return steps


def _greedy(prompts, n):
    return [Request(prompt_tokens=list(p),
                    sampling=SamplingParams(temperature=0.0,
                                            max_new_tokens=n))
            for p in prompts]


def test_paged_engine_matches_oracle(dense_setup, rng):
    jcfg, jp, tcfg, tp = dense_setup
    # 64-token prompt exercises chunked prefill (max_prefill_tokens=32)
    prompts = [list(rng.integers(1, jcfg.vocab_size, size=n))
               for n in (11, 64)]
    oracle = [oracle_generate(jcfg, jp, p, 6) for p in prompts]
    ex = RealExecutor(tcfg, tp, num_blocks=256, block_size=16, hw=TPU_V5E,
                      max_model_len=256, device="cpu")
    eng = LLMEngine(tcfg, ex, num_blocks=256, block_size=16, max_num_seqs=8,
                    max_prefill_tokens=32, max_model_len=256)
    reqs = _greedy(prompts, 6)
    run_engine(eng, reqs)
    for r, o in zip(reqs, oracle):
        assert r.status.value == "finished"
        assert r.output_tokens == o
    eng.allocator.check_invariants()
    assert eng.allocator.num_free() == 256
    assert ex.prefill_computes == 2 and ex.decode_steps > 0


def test_packed_prompts_match_oracle(dense_setup, rng):
    """Four prompts admitted in one step under a budget of 96 tokens: the
    first three end there and are computed in one packed pass, the fourth
    (60) ends in the next step, a pass alone; every request's greedy tokens
    are the JAX oracle's."""
    jcfg, jp, tcfg, tp = dense_setup
    prompts = [list(rng.integers(1, jcfg.vocab_size, size=n))
               for n in (11, 23, 7, 60)]
    oracle = [oracle_generate(jcfg, jp, p, 6) for p in prompts]
    ex = RealExecutor(tcfg, tp, num_blocks=256, block_size=16, hw=TPU_V5E,
                      max_model_len=256, device="cpu", max_prefill_tokens=96)
    eng = LLMEngine(tcfg, ex, num_blocks=256, block_size=16, max_num_seqs=8,
                    max_prefill_tokens=96, max_model_len=256)
    reqs = _greedy(prompts, 6)
    run_engine(eng, reqs)
    assert [r.output_tokens for r in reqs] == oracle
    assert (ex.prefill_passes, ex.prefill_computes) == (2, 4)
    eng.allocator.check_invariants()
    assert eng.allocator.num_free() == 256


def test_preemption_under_block_pressure(dense_setup, rng):
    # 3 seqs prefill into 15/16 blocks; decode growth forces eviction
    jcfg, jp, tcfg, tp = dense_setup
    prompts = [list(rng.integers(1, jcfg.vocab_size, size=40))
               for _ in range(3)]
    ex = RealExecutor(tcfg, tp, num_blocks=16, block_size=8, hw=TPU_V5E,
                      max_model_len=96, device="cpu")
    eng = LLMEngine(tcfg, ex, num_blocks=16, block_size=8, max_num_seqs=4,
                    max_prefill_tokens=64, max_model_len=96,
                    enable_prefix_caching=False)
    reqs = _greedy(prompts, 6)
    run_engine(eng, reqs)
    assert all(r.status.value == "finished" for r in reqs)
    assert eng.metrics.preemptions > 0, "scenario exerted no block pressure"
    for r, p in zip(reqs, prompts):
        assert r.output_tokens == oracle_generate(jcfg, jp, p, 6)
    eng.allocator.check_invariants()
    assert eng.allocator.num_free() == 16


def test_prefix_caching_does_not_change_outputs(dense_setup, rng):
    """Same requests with and without prefix caching -> identical tokens,
    equal to the JAX oracle (shared prefixes make the cache fire)."""
    jcfg, jp, tcfg, tp = dense_setup
    shared = list(rng.integers(1, jcfg.vocab_size, size=32))
    prompts = [shared + list(rng.integers(1, jcfg.vocab_size, size=8))
               for _ in range(2)]
    outs = {}
    for caching in (False, True):
        ex = RealExecutor(tcfg, tp, num_blocks=128, block_size=8,
                          hw=TPU_V5E, max_model_len=128, device="cpu")
        eng = LLMEngine(tcfg, ex, num_blocks=128, block_size=8,
                        max_num_seqs=4, max_prefill_tokens=128,
                        max_model_len=128, enable_prefix_caching=caching)
        reqs = _greedy(prompts, 4)
        run_engine(eng, reqs)
        outs[caching] = [r.output_tokens for r in reqs]
        if caching:
            assert eng.metrics.tokens_prefilled < sum(len(p)
                                                      for p in prompts)
    assert outs[False] == outs[True]
    assert outs[True] == [oracle_generate(jcfg, jp, p, 4) for p in prompts]


def test_write_prefill_and_paged_decode_match_jax(dense_setup, rng):
    """write_prefill, then one paged decode_step, on identical pools and
    tables: logits and the updated pool agree with the JAX package."""
    jcfg, jp, tcfg, tp = dense_setup
    bs, nb, mb = 8, 12, 4
    jpool = jpaged.init_pool(jcfg, nb, bs)
    tpool = tpaged.init_pool(tcfg, nb, bs, device="cpu")
    tables = [[3, 0, 7], [5, 9]]           # block 0 is an ordinary block
    lens = [19, 9]
    for table, n in zip(tables, lens):
        toks = rng.integers(1, jcfg.vocab_size, size=(1, n)).astype(np.int32)
        _, jc = japi.prefill_fn(jp, jcfg, {"tokens": jnp.asarray(toks)})
        _, tc = tapi.prefill_fn(tp, tcfg, {"tokens": torch.from_numpy(
            toks).long()})
        jpool = jpaged.write_prefill(jpool, jc, jnp.asarray(table, jnp.int32),
                                     bs)
        tpaged.write_prefill(tpool, tc, torch.tensor(table), bs)
    np.testing.assert_allclose(tpool["k"].numpy(), np.asarray(jpool["k"]),
                               rtol=1e-4, atol=1e-4)
    bt = np.zeros((2, mb), np.int32)
    for i, table in enumerate(tables):
        bt[i, :len(table)] = table
    toks = np.array([11, 22], np.int32)
    pos = np.array(lens, np.int32)
    jl, jpool = jpaged.decode_step(jp, jcfg, jnp.asarray(toks),
                                   jnp.asarray(pos), jpool, jnp.asarray(bt))
    tl, tpool = tpaged.decode_step(tp, tcfg, torch.from_numpy(toks).long(),
                                   torch.from_numpy(pos).long(), tpool,
                                   torch.from_numpy(bt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(),
                                   np.asarray(jpool[name]), rtol=1e-4,
                                   atol=1e-4)


def test_sim_executor_matches_jax_timing():
    """The copied roofline gives the JAX SimExecutor's step times."""
    from repro.config import GPU_H100 as JH100
    from repro.engine.executor import SimExecutor as JSim
    from repro_torch.config import GPU_H100
    pre = [{"chunk": (0, 300)}, {"chunk": (512, 700)}]
    dec = {"slots": [0, 1, 2], "pos": [40, 900, 3000]}
    for name in ("mistral-small-24b", "qwen3-1.7b"):
        a = SimExecutor(tconfigs.get(name), GPU_H100).step(pre, dec)[2]
        b = JSim(jconfigs.get(name), JH100).step(pre, dec)[2]
        assert a == b


def test_serve_entry_point_on_cpu(dense_setup, rng):
    """launch/drive.py's engine and request loop, asked for the CPU, serve
    greedy requests to the JAX oracle's tokens and time each request."""
    from repro_torch.launch import drive
    jcfg, jp, tcfg, tp = dense_setup
    eng = drive.build_engine(tcfg, tp, "cpu", num_blocks=64, block_size=16,
                             max_num_seqs=4, max_prefill_tokens=32,
                             max_model_len=256)
    prompts = drive.make_prompts(tcfg.vocab_size, (9, 40), seed=3)
    reqs, timing = drive.serve(eng, prompts, 4)
    for r, p, t in zip(reqs, prompts, timing):
        assert r.output_tokens == oracle_generate(jcfg, jp, p, 4)
        assert 0 < t["ttft_s"] <= t["latency_s"]
