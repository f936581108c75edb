"""The port's audio family (whisper) against the JAX package on the same
weights and inputs: LayerNorm, the encoder, cross attention, prefill and
decode logits through the model API, f32 at reduced size; and the engine's
refusal of audio, which the reference's executor cannot serve either."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models import whisper as twhisper  # noqa: E402

TOL = dict(rtol=1e-5, atol=2e-5)        # one op, f32
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)  # a whole model's logits, f32


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get("whisper-small").reduced()
    tcfg = tconfigs.get("whisper-small").reduced()
    jp, _ = japi.init_params(jcfg, jax.random.key(5))
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _frames(cfg, rng, b=2):
    return rng.normal(size=(b, cfg.encoder_seq_len,
                            cfg.frontend_dim)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_matches_jax(dtype, rng):
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    s = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(
            tcm.layer_norm(_t(x), _t(s), _t(b), 1e-5).numpy(),
            _np(jcm.layer_norm(x, s, b, 1e-5)), **TOL)
        return
    out = tcm.layer_norm(_t(x).bfloat16(), _t(s).bfloat16(),
                         _t(b).bfloat16())
    ref = jcm.layer_norm(*(jnp.asarray(a, jnp.bfloat16) for a in (x, s, b)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _np(ref), rtol=1e-2,
                               atol=1e-2)


def test_qkv_with_learned_positions_applies_no_rope(setup, rng):
    """rope_theta 0: positions are learned, so q and k are the plain
    projections whatever the positions, in both packages."""
    jcfg, tcfg, jp, tp = setup
    lj = jax.tree.map(lambda a: a[0], jp["dec_layers"]["attn"])
    lt = {k: v[0] for k, v in tp["dec_layers"]["attn"].items()}
    x = rng.normal(size=(2, 6, jcfg.d_model)).astype(np.float32)
    pos = np.arange(100, 106, dtype=np.int32)[None]
    jq = jcm._qkv(lj, jcfg, x, pos)
    tq = tcm._qkv(lt, tcfg, _t(x), _t(pos).long())
    tq0 = tcm._qkv(lt, tcfg, _t(x), _t(0 * pos).long())
    for a, b, c in zip(tq, jq, tq0):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
        assert torch.equal(a, c)


def test_qkv_rope_off_matches_jax(rng):
    """``rope=False`` leaves q and k unrotated even where rope_theta > 0,
    as the JAX package's ``_qkv`` does."""
    jcfg = jconfigs.get("smollm-135m").reduced()
    tcfg = tconfigs.get("smollm-135m").reduced()
    jp, _ = japi.init_params(jcfg, jax.random.key(2))
    lj = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    lt = {k: _t(v) for k, v in lj.items()}
    x = rng.normal(size=(1, 4, jcfg.d_model)).astype(np.float32)
    pos = np.arange(50, 54, dtype=np.int32)[None]
    jq = jcm._qkv(lj, jcfg, x, pos, rope=False)
    tq = tcm._qkv(lt, tcfg, _t(x), _t(pos).long(), rope=False)
    roped = tcm._qkv(lt, tcfg, _t(x), _t(pos).long())
    for a, b in zip(tq, jq):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    assert not torch.allclose(tq[0], roped[0])


def test_encode_matches_jax(setup, rng):
    jcfg, tcfg, jp, tp = setup
    frames = _frames(jcfg, rng)
    np.testing.assert_allclose(
        twhisper.encode(tp, tcfg, _t(frames)).numpy(),
        _np(jwhisper.encode(jp, jcfg, frames)), **MODEL_TOL)


def test_cross_attention_matches_jax(setup, rng):
    jcfg, tcfg, jp, tp = setup
    lj = jax.tree.map(lambda a: a[1], jp["dec_layers"])
    lt = ttfm.layer(tp["dec_layers"], 1)
    enc = rng.normal(size=(2, jcfg.encoder_seq_len,
                           jcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, 3, jcfg.d_model)).astype(np.float32)
    jk, jv = jwhisper._cross_kv(lj, jcfg, enc)
    tk, tv = twhisper._cross_kv(lt, _t(enc))
    np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), **TOL)
    np.testing.assert_allclose(
        twhisper._cross_attend(lt, tcfg, _t(x), tk, tv).numpy(),
        _np(jwhisper._cross_attend(lj, jcfg, x, jk, jv)), **TOL)


@pytest.mark.parametrize("t", [1, 9, 40])
def test_prefill_and_decode_match_jax(setup, t, rng):
    """prefill_fn with frames, then decode_fn with learned positions indexed
    by pos; the self-attention cache grows by pad_cache, the cross caches
    never do."""
    jcfg, tcfg, jp, tp = setup
    frames = _frames(jcfg, rng)
    toks = rng.integers(1, jcfg.vocab_size, size=(2, t)).astype(np.int32)
    jl, jc = japi.prefill_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                        "frames": jnp.asarray(frames)})
    tl, tc = tapi.prefill_fn(tp, tcfg, {"tokens": _t(toks).long(),
                                        "frames": _t(frames)})
    np.testing.assert_allclose(tl.numpy(), _np(jl), **MODEL_TOL)
    for k in ("k", "v", "ck", "cv"):
        np.testing.assert_allclose(tc[k].numpy(), _np(jc[k]), **MODEL_TOL)
    n_new = 3
    jc = japi.pad_cache(jcfg, jc, t + n_new + 2)
    tc = tapi.pad_cache(tcfg, tc, t + n_new + 2)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    nxt = np.argmax(_np(jl), -1).astype(np.int32)
    for i in range(n_new):
        pos = np.full((2,), t + i, np.int32)
        jl, jc = japi.decode_fn(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.asarray(pos))
        tl, tc = tapi.decode_fn(tp, tcfg, _t(nxt).long(), tc, _t(pos).long())
        np.testing.assert_allclose(tl.numpy(), _np(jl), **MODEL_TOL)
        nxt = np.argmax(_np(jl), -1).astype(np.int32)


def test_plain_attention_prefill_matches_default(setup, rng):
    """The decoder's self-attention through the flash-prefill op (its plain
    version here) and through plain chunked attention give one result."""
    _, tcfg, _, tp = setup
    batch = {"tokens": torch.from_numpy(rng.integers(1, 100, size=(1, 21))),
             "frames": _t(_frames(tcfg, rng, b=1))}
    a, ca = tapi.prefill_fn(tp, tcfg, batch)
    b, cb = tapi.prefill_fn(tp, tcfg, batch,
                            attention=tcm.plain_prefill_attention)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(ca["k"], cb["k"])


def test_init_cache_matches_jax():
    jcfg = jconfigs.get("whisper-small").reduced()
    tcfg = tconfigs.get("whisper-small").reduced()
    jc = japi.init_cache(jcfg, 2, 11)
    tc = tapi.init_cache(tcfg, 2, 11, device="cpu")
    assert {k: (v.shape, str(v.dtype)) for k, v in jc.items()} == \
        {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
         for k, v in tc.items()}


def test_executor_refuses_audio():
    """The reference's executor passes no frames, so its audio prefill
    fails on the missing key; the port's refuses audio up front, saying
    why."""
    from repro_torch.config import GPU_H100
    from repro_torch.engine.executor import RealExecutor
    tcfg = tconfigs.get("whisper-small").reduced()
    params = tapi.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="audio frames"):
        RealExecutor(tcfg, params, num_blocks=8, block_size=4, hw=GPU_H100,
                     device="cpu")
    jcfg = jconfigs.get("whisper-small").reduced()
    jp, _ = japi.init_params(jcfg, jax.random.key(0))
    with pytest.raises(KeyError, match="frames"):
        japi.prefill_fn(jp, jcfg, {"tokens": jnp.ones((1, 4), jnp.int32)})
