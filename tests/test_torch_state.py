"""The port's state families (mamba2: ssm; griffin: hybrid) against the JAX
package on the same weights and inputs: the scans and convolutions, the
windowed attention and its rolling cache, whole prefill / decode logits. f32
unless a test says otherwise; inputs come from a numpy seed. The slot-state
executor's tests are in test_torch_state_engine.py."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import griffin as tgriffin  # noqa: E402
from repro_torch.models import mamba2 as tmamba2  # noqa: E402

# f32 on both sides; module outputs agree to float rounding in another
# summation order (the doubling scan against lax.associative_scan, einsum
# orders), whole-model logits to ~1e-5
TOL = dict(rtol=1e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 weights and activations: XLA and PyTorch round at other places, so
# one op agrees to a few bf16 steps, and a whole model's logits and caches
# (rounding compounded over its layers) to a few steps of values near 4
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
BF16_MODEL_TOL = dict(rtol=5e-2, atol=1e-1)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _cfgs(name, **changes):
    jcfg = dataclasses.replace(jconfigs.get(name).reduced(), **changes)
    tcfg = dataclasses.replace(tconfigs.get(name).reduced(), **changes)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _cached_params(name, seed, changes):
    jcfg, tcfg = _cfgs(name, **dict(changes))
    jp, _ = japi.init_params(jcfg, jax.random.key(seed))
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _params(name, seed=3, **changes):
    """Reduced configs of both packages and the JAX weights carried over;
    built once per argument set (nothing here writes to weights)."""
    return _cached_params(name, seed, tuple(sorted(changes.items())))


def _layer(tree, i=0):
    """Layer i of a stacked tree, as a JAX tree and as the port's."""
    return (jax.tree.map(lambda a: a[i], tree),
            tparams.from_numpy(jax.tree.map(lambda a: np.asarray(a[i]), tree),
                               "cpu"))


# --------------------------------------------------------------------------
# mamba2: the SSD scans
# --------------------------------------------------------------------------

def _ssd_inputs(rng, t, g, b=2, h=4, p=8, s=16):
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    B = rng.normal(size=(b, t, g, s)).astype(np.float32)
    C = rng.normal(size=(b, t, g, s)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("t", [64, 96])
def test_ssd_chunked_over_several_chunks_matches_jax(t, g, rng):
    """Chunk 32: T 64 and 96 run the inter-chunk recurrence over 2 and 3
    chunk states (a single chunk never does)."""
    args = _ssd_inputs(rng, t, g)
    jy, js = jmamba2.ssd_chunked(*args, chunk=32)
    ty, ts = tmamba2.ssd_chunked(*map(_t, args), chunk=32)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)


def test_ssd_chunked_from_an_initial_state_matches_jax(rng):
    args = _ssd_inputs(rng, 64, 1)
    init = rng.normal(size=(2, 4, 8, 16)).astype(np.float32)
    jy, js = jmamba2.ssd_chunked(*args, chunk=16, init_state=init)
    ty, ts = tmamba2.ssd_chunked(*map(_t, args), chunk=16,
                                 init_state=_t(init))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)


def test_ssd_step_matches_jax_and_continues_the_chunked_scan(rng):
    x, dt, A, B, C = _ssd_inputs(rng, 33, 2)
    _, state = tmamba2.ssd_chunked(*map(_t, (x[:, :32], dt[:, :32], A,
                                             B[:, :32], C[:, :32])), chunk=32)
    jy, jst = jmamba2.ssd_step(x[:, 32], dt[:, 32], A, B[:, 32], C[:, 32],
                               state.numpy())
    ty, tst = tmamba2.ssd_step(*map(_t, (x[:, 32], dt[:, 32], A, B[:, 32],
                                         C[:, 32])), state)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), _np(jst), **TOL)
    # the step continues the scan: the 33rd output of one 33-token chunk
    whole, _ = jmamba2.ssd_chunked(x, dt, A, B, C, chunk=33)
    np.testing.assert_allclose(ty.numpy(), _np(whole)[:, 32], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("t", [40, 50])
def test_ssd_chunked_refuses_a_length_off_the_chunk_in_both(t, rng):
    """T above the chunk and not a multiple of it: the reference asserts,
    the port raises a ValueError naming the chunk; neither pads."""
    args = _ssd_inputs(rng, t, 1)
    with pytest.raises(AssertionError, match="chunk"):
        jmamba2.ssd_chunked(*args, chunk=32)
    with pytest.raises(ValueError, match="chunk 32"):
        tmamba2.ssd_chunked(*map(_t, args), chunk=32)


def test_mamba2_prefill_refuses_a_length_off_the_chunk_in_both(rng):
    jcfg, tcfg, jp, tp = _params("mamba2-780m")
    toks = rng.integers(1, jcfg.vocab_size, size=(1, 40)).astype(np.int32)
    with pytest.raises(AssertionError):
        japi.prefill_fn(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with pytest.raises(ValueError, match="chunk"):
        tapi.prefill_fn(tp, tcfg, {"tokens": _t(toks).long()})


# --------------------------------------------------------------------------
# griffin: RG-LRU and the causal conv
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 37, 64, 100])
def test_rg_lru_scan_matches_jax(t, rng):
    jcfg, _, jp, _ = _params("recurrentgemma-9b")
    jl, tl = _layer(jp["groups"]["rec1"])
    u = rng.normal(size=(2, t, jcfg.rnn_width)).astype(np.float32)
    np.testing.assert_allclose(tgriffin.rg_lru_scan(tl, _t(u)).numpy(),
                               _np(jgriffin.rg_lru_scan(jl, u)), **TOL)


def test_linear_scan_is_the_sequential_recurrence(rng):
    log_a = -np.abs(rng.normal(size=(2, 77, 5))).astype(np.float32)
    x = rng.normal(size=(2, 77, 5)).astype(np.float32)
    h, want = np.zeros((2, 5), np.float32), []
    for i in range(77):
        h = np.exp(log_a[:, i]) * h + x[:, i]
        want.append(h)
    np.testing.assert_allclose(
        tgriffin.linear_scan(_t(log_a), _t(x)).numpy(),
        np.stack(want, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rg_lru_step_matches_jax(dtype, rng):
    """u in the params' dtype against an f32 state, as decode gives it."""
    jcfg, _, jp, _ = _params(
        "recurrentgemma-9b",
        param_dtype="float32" if dtype == "f32" else "bfloat16")
    jl, tl = _layer(jp["groups"]["rec2"])
    u = rng.normal(size=(3, jcfg.rnn_width)).astype(np.float32)
    h = rng.normal(size=(3, jcfg.rnn_width)).astype(np.float32)
    ju = jnp.asarray(u, jl["w_in"].dtype)
    tu = _t(u).to(tl["w_in"].dtype)
    jo, jh = jgriffin.rg_lru_step(jl, ju, h)
    to, th = tgriffin.rg_lru_step(tl, tu, _t(h))
    assert to.dtype == tu.dtype and th.dtype == torch.float32
    tol = TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(to.float().numpy(), _np(jo), **tol)
    np.testing.assert_allclose(th.numpy(), _np(jh), **tol)


@pytest.mark.parametrize("t", [1, 2, 9, 40])
def test_causal_conv_matches_jax(t, rng):
    x = rng.normal(size=(2, t, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    np.testing.assert_allclose(
        tgriffin.causal_conv(_t(x), _t(w), _t(b)).numpy(),
        _np(jgriffin.causal_conv(x, w, b)), **TOL)


@pytest.mark.parametrize("state", ["f32", "bf16", "f32_state_bf16_x"])
def test_causal_conv_step_matches_jax(state, rng):
    """The last case is JAX's silent promotion: a bf16 input against an f32
    state (the executor's slab) concatenates and sums in f32."""
    x = rng.normal(size=(2, 24)).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    jt = {"f32": (jnp.float32, jnp.float32), "bf16": (jnp.bfloat16,) * 2,
          "f32_state_bf16_x": (jnp.float32, jnp.bfloat16)}[state]
    tt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    jx, jst = jnp.asarray(x, jt[1]), jnp.asarray(st, jt[0])
    jw, jb = jnp.asarray(w, jt[1]), jnp.asarray(b, jt[1])
    jy, jnew = jgriffin.causal_conv_step(jx, jst, jw, jb)
    ty, tnew = tgriffin.causal_conv_step(
        _t(x).to(tt[jt[1]]), _t(st).to(tt[jt[0]]), _t(w).to(tt[jt[1]]),
        _t(b).to(tt[jt[1]]))
    assert str(ty.dtype).split(".")[-1] == str(jy.dtype)
    assert str(tnew.dtype).split(".")[-1] == str(jnew.dtype)
    tol = TOL if state == "f32" else BF16_TOL
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), **tol)
    np.testing.assert_allclose(tnew.float().numpy(), _np(jnew), **tol)


# --------------------------------------------------------------------------
# windowed attention: prefill cache in rolling layout, rolling decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t", [5, 40, 64, 100, 130])
def test_windowed_attention_prefill_and_rolling_decode_match_jax(t, rng):
    """Reduced window 64: T below it pads the cache, T at or past it rolls
    the last 64 positions by (T - 64) % 64; then three decode steps write
    slot pos % 64 and mask the slots not yet written."""
    jcfg, tcfg, jp, tp = _params("recurrentgemma-9b")
    jl, tl = _layer(jp["groups"]["attn"]["attn"])
    w = jcfg.attn_window
    x = rng.normal(size=(2, t, jcfg.d_model)).astype(np.float32)
    jo, jk, jv = jcm.attention_prefill(jl, jcfg, x, window=w)
    to, tk, tv = tcm.attention_prefill(tl, tcfg, _t(x), window=w)
    np.testing.assert_allclose(to.numpy(), _np(jo), **TOL)
    assert tuple(tk.shape) == jk.shape == (2, w, 1, jcfg.head_dim)
    np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), **TOL)
    for i in range(3):
        xs = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        pos = np.array([t + i, t + i], np.int32)
        jo, jk, jv = jcm.attention_decode(jl, jcfg, xs, jk, jv, pos,
                                          window=w)
        to, tk, tv = tcm.attention_decode(tl, tcfg, _t(xs), tk, tv,
                                          _t(pos).long(), window=w)
        np.testing.assert_allclose(to.numpy(), _np(jo), **TOL)
        np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)


def test_attention_decode_promotes_a_bf16_query_against_an_f32_cache(rng):
    """bf16 weights against an f32 cache: JAX computes the products in f32
    and returns f32; so does the port."""
    jcfg, tcfg, jp, tp = _params("recurrentgemma-9b", param_dtype="bfloat16")
    jl, tl = _layer(jp["groups"]["attn"]["attn"])
    w = jcfg.attn_window
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(2, w, 1, jcfg.head_dim)).astype(np.float32)
    cv = rng.normal(size=(2, w, 1, jcfg.head_dim)).astype(np.float32)
    pos = np.array([3, 90], np.int32)
    jo, _, _ = jcm.attention_decode(jl, jcfg, jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(ck), jnp.asarray(cv),
                                    jnp.asarray(pos), window=w)
    to, _, _ = tcm.attention_decode(tl, tcfg, _t(x).bfloat16(), _t(ck),
                                    _t(cv), _t(pos).long(), window=w)
    assert to.dtype == torch.float32 and jo.dtype == jnp.float32
    np.testing.assert_allclose(to.numpy(), _np(jo), **BF16_TOL)


# --------------------------------------------------------------------------
# whole models: prefill_fn / decode_fn
# --------------------------------------------------------------------------

def _prefill_decode(jcfg, tcfg, jp, tp, t, rng, n_new=3, tol=MODEL_TOL):
    toks = rng.integers(1, jcfg.vocab_size, size=(2, t)).astype(np.int32)
    jl, jc = japi.prefill_fn(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = tapi.prefill_fn(tp, tcfg, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(tl.float().numpy(), _np(jl), **tol)
    assert jc.keys() == tc.keys()
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
        np.testing.assert_allclose(tc[k].float().numpy(), _np(jc[k]), **tol)
    assert tapi.pad_cache(tcfg, tc, t + 50) is tc
    nxt = np.argmax(_np(jl), -1).astype(np.int32)
    for i in range(n_new):
        pos = np.full((2,), t + i, np.int32)
        jl, jc = japi.decode_fn(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.asarray(pos))
        tl, tc = tapi.decode_fn(tp, tcfg, _t(nxt).long(), tc, _t(pos).long())
        np.testing.assert_allclose(tl.float().numpy(), _np(jl), **tol)
        for k in jc:
            np.testing.assert_allclose(tc[k].float().numpy(), _np(jc[k]),
                                       **tol)
        nxt = np.argmax(_np(jl), -1).astype(np.int32)


@pytest.mark.parametrize("t", [5, 32, 64, 96])
def test_mamba2_prefill_and_decode_match_jax(t, rng):
    _prefill_decode(*_params("mamba2-780m"), t, rng)


@pytest.mark.parametrize("layers,t", [(3, 40), (3, 100), (5, 70), (5, 130)],
                         ids=["3layers_T40", "3layers_T100", "tail_T70",
                              "tail_T130"])
def test_griffin_prefill_and_decode_match_jax(layers, t, rng):
    """3 layers are one (rec, rec, attn) group and no tail; 5 add a tail of
    two rec layers. T past the reduced window of 64 rolls the KV cache."""
    _prefill_decode(*_params("recurrentgemma-9b", num_layers=layers), t, rng)


@pytest.mark.parametrize("name", ["mamba2-780m", "recurrentgemma-9b"])
def test_bf16_decode_matches_jax_on_its_own_caches(name, rng):
    """bf16 weights: prefill and decode against the caches prefill gives
    (bf16 conv / KV, f32 recurrent states), as the reference runs them."""
    _prefill_decode(*_params(name, param_dtype="bfloat16"), 32, rng,
                    n_new=2, tol=BF16_MODEL_TOL)


def test_griffin_init_with_a_tail_matches_jax_tree():
    """5 layers: one group and a tail of two rec layers, each leaf with the
    JAX tree's shape, dtype and scale."""
    _, tcfg, jp, _ = _params("recurrentgemma-9b", num_layers=5)
    tp = tapi.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert flat_j.keys() == flat_t.keys()
    assert tp["tail"]["w_in"].shape[0] == 2
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape, k
        np.testing.assert_allclose(float(flat_t[k].std()),
                                   float(np.std(np.asarray(v))), rtol=0.1,
                                   atol=1e-6, err_msg=k)


def test_init_cache_matches_jax():
    for name, layers in (("mamba2-780m", 2), ("recurrentgemma-9b", 3),
                         ("recurrentgemma-9b", 5)):
        jcfg, tcfg = _cfgs(name, num_layers=layers)
        jc = japi.init_cache(jcfg, 3, 17)
        tc = tapi.init_cache(tcfg, 3, 17, device="cpu")
        assert {k: (v.shape, str(v.dtype)) for k, v in jc.items()} == \
            {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
             for k, v in tc.items()}
