"""The port's slot-state executor (ssm and hybrid families) on the CPU:
twins of tests/test_engine.py's state-executor test, whose greedy tokens
must equal the JAX dense oracle's, and the executor with bf16 weights over
its f32 slab."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.config import TPU_V5E  # noqa: E402
from repro_torch.engine.engine import LLMEngine  # noqa: E402
from repro_torch.engine.executor import RealExecutor  # noqa: E402
from repro_torch.engine.request import Request, SamplingParams  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402


def _params(name, seed=3, **changes):
    """Reduced configs of both packages and the JAX weights carried over."""
    jcfg = dataclasses.replace(jconfigs.get(name).reduced(), **changes)
    tcfg = dataclasses.replace(tconfigs.get(name).reduced(), **changes)
    jp, _ = japi.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jp, tparams.from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu")


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


def _serve(tcfg, tp, prompts, n_new, max_prefill_tokens, device="cpu"):
    ex = RealExecutor(tcfg, tp, num_blocks=64, block_size=16, hw=TPU_V5E,
                      max_model_len=256, max_slots=4, device=device)
    eng = LLMEngine(tcfg, ex, num_blocks=64, block_size=16, max_num_seqs=4,
                    max_prefill_tokens=max_prefill_tokens, max_model_len=256,
                    enable_prefix_caching=False)
    reqs = [Request(prompt_tokens=list(p), sampling=SamplingParams(
        temperature=0.0, max_new_tokens=n_new)) for p in prompts]
    now = 0.0
    for r in reqs:
        eng.add_request(r, now)
    while eng.has_work():
        now += max(eng.step(now).elapsed, 1e-4)
    assert all(r.status.value == "finished" for r in reqs)
    return reqs, ex


@pytest.mark.parametrize("name,layers,lens", [
    ("mamba2-780m", 2, (9, 17, 64, 96)),
    ("recurrentgemma-9b", 3, (11, 70, 100)),
    ("recurrentgemma-9b", 5, (9, 64, 130)),
], ids=["mamba2", "hybrid", "hybrid_tail"])
def test_state_executor_matches_oracle(name, layers, lens, rng):
    """Twins of tests/test_engine.py's state-executor test: mamba2 prompts
    over several SSD chunks (reduced chunk 32), hybrid prompts past the
    reduced window of 64, prefilled in chunks of 32 and decoded in one
    batch of slots; greedy tokens equal the JAX oracle's."""
    jcfg, tcfg, jp, tp = _params(name, num_layers=layers)
    prompts = [list(rng.integers(1, jcfg.vocab_size, size=n)) for n in lens]
    oracle = [oracle_generate(jcfg, jp, p, 5) for p in prompts]
    reqs, ex = _serve(tcfg, tp, prompts, 5, max_prefill_tokens=32)
    assert [r.output_tokens for r in reqs] == oracle
    assert ex.prefill_computes == len(prompts) and ex.decode_steps >= 4
    assert all(v.dtype == torch.float32 for v in ex.cache.values())


@pytest.mark.parametrize("name", ["mamba2-780m", "recurrentgemma-9b"])
def test_state_executor_serves_bf16_weights_over_f32_slabs(name, rng):
    """bf16 weights and the f32 slab: decode reads the slab back in the
    model's cache dtypes and runs without a dtype error; its first decode's
    tokens match decode_fn's on the prefill's own caches."""
    _, tcfg, _, tp = _params(name, param_dtype="bfloat16")
    prompts = [list(rng.integers(1, tcfg.vocab_size, size=n))
               for n in (9, 32)]
    reqs, ex = _serve(tcfg, tp, prompts, 3, max_prefill_tokens=64)
    assert all(len(r.output_tokens) == 3 for r in reqs)
    assert ex.cache_dtypes == {k: v.dtype for k, v in tapi.init_cache(
        tcfg, 1, 1, dtype=torch.bfloat16, device="cpu").items()}
    for p, r in zip(prompts, reqs):
        logits, cache = tapi.prefill_fn(tp, tcfg,
                                        {"tokens": torch.tensor([p])})
        assert int(logits[0].argmax()) == r.output_tokens[0]


def test_state_executor_keeps_slots_apart(rng):
    """Two sequences in two slots: each one's tokens are what it gives when
    served alone."""
    jcfg, tcfg, jp, tp = _params("recurrentgemma-9b")
    prompts = [list(rng.integers(1, jcfg.vocab_size, size=n))
               for n in (20, 33)]
    together, _ = _serve(tcfg, tp, prompts, 4, max_prefill_tokens=64)
    for p, r in zip(prompts, together):
        alone, _ = _serve(tcfg, tp, [p], 4, max_prefill_tokens=64)
        assert alone[0].output_tokens == r.output_tokens
