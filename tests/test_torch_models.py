"""The port's model code against the JAX package on the same weights and
inputs: building blocks, then whole prefill / decode logits on reduced
configurations, weights carried across by ``repro_torch.params``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402

# f32 on both sides; the two frameworks sum matrix products in different
# orders, so whole-model logits agree to ~1e-5, not bit for bit
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _jax_params(name, seed=7):
    cfg = jconfigs.get(name).reduced()
    params, _ = japi.init_params(cfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    return (cfg, tconfigs.get(name).reduced(), params,
            tparams.from_numpy(tree, "cpu"))


def test_rms_norm_matches_jax(rng):
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    s = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(tcm.rms_norm(_t(x), _t(s), 1e-6).numpy(),
                               _np(jcm.rms_norm(x, s, 1e-6)), **TOL)


def test_rms_norm_bf16_matches_jax(rng):
    x = rng.normal(size=(3, 128)).astype(np.float32)
    s = rng.normal(size=(128,)).astype(np.float32)
    out = tcm.rms_norm(_t(x).bfloat16(), _t(s).bfloat16()).float().numpy()
    ref = _np(jcm.rms_norm(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(s, jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta, rng):
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        tcm.apply_rope(_t(x), _t(pos).long(), theta).numpy(),
        _np(jcm.apply_rope(x, pos, theta)), **TOL)


def test_rope_tables_made_once_rotate_as_apply_rope(rng):
    """One ``rope_tables`` pair, made once for a pass, rotates q and k bit
    for bit as ``apply_rope`` does for each alone; ``_qkv`` takes it."""
    x = _t(rng.normal(size=(3, 1, 4, 32)).astype(np.float32))
    pos = torch.tensor([[5], [0], [417]])
    tables = tcm.rope_tables(pos, 32, 1_000_000.0)
    for t in (x, x[:, :, :2].bfloat16()):
        assert torch.equal(tcm.rotate(t, tables),
                           tcm.apply_rope(t, pos, 1_000_000.0))
    _, tcfg, _, tp = _jax_params("qwen3-1.7b")
    lt = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    h = _t(rng.normal(size=(3, 1, tcfg.d_model)).astype(np.float32))
    made = tcm.rope_tables(pos, tcfg.head_dim, tcfg.rope_theta)
    for a, b in zip(tcm._qkv(lt, tcfg, h, pos),
                    tcm._qkv(lt, tcfg, h, pos, tables=made)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "smollm-135m"])
def test_qkv_matches_jax(name, rng):
    """qwen3 has qk-norm, smollm does not."""
    jcfg, tcfg, jp, tp = _jax_params(name)
    lj = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    lt = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    x = rng.normal(size=(2, 6, jcfg.d_model)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None]
    jq = jcm._qkv(lj, jcfg, x, pos)
    tq = tcm._qkv(lt, tcfg, _t(x), _t(pos).long())
    for a, b in zip(tq, jq):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_jax(gated, rng):
    d, f = 32, 64
    w = lambda *s: rng.normal(size=s).astype(np.float32) * 0.2  # noqa: E731
    p = ({"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)} if gated
         else {"w_up": w(d, f), "b_up": w(f), "w_down": w(f, d),
               "b_down": w(d)})
    x = rng.normal(size=(3, d)).astype(np.float32)
    np.testing.assert_allclose(
        tcm.mlp({k: _t(v) for k, v in p.items()}, _t(x)).numpy(),
        _np(jcm.mlp(p, x)), **TOL)


@pytest.mark.parametrize("tied", [True, False])
def test_unembed_matches_jax(tied, rng):
    p = {"tok": rng.normal(size=(50, 16)).astype(np.float32)}
    if not tied:
        p["unembed"] = rng.normal(size=(16, 50)).astype(np.float32)
    x = rng.normal(size=(2, 1, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tcm.unembed({k: _t(v) for k, v in p.items()}, _t(x)).numpy(),
        _np(jcm.unembed(p, x)), **TOL)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mistral-small-24b"])
def test_prefill_and_decode_match_jax(name, rng):
    jcfg, tcfg, jp, tp = _jax_params(name)
    t, n_new = 13, 3
    toks = rng.integers(1, jcfg.vocab_size, size=(2, t)).astype(np.int32)
    jl, jc = japi.prefill_fn(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = tapi.prefill_fn(tp, tcfg, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), _np(jc["k"]), **TOL)
    jc = japi.pad_cache(jcfg, jc, t + n_new)
    tc = tapi.pad_cache(tcfg, tc, t + n_new)
    nxt = np.argmax(_np(jl), -1).astype(np.int32)
    for i in range(n_new):
        pos = np.full((2,), t + i, np.int32)
        jl, jc = japi.decode_fn(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.asarray(pos))
        tl, tc = tapi.decode_fn(tp, tcfg, _t(nxt).long(), tc, _t(pos).long())
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        nxt = np.argmax(_np(jl), -1).astype(np.int32)


def test_vlm_prefill_with_patches_and_decode_match_jax(rng):
    """pixtral's backbone: patch embeddings, projected by vision_proj, take
    the place of the first num_patches token embeddings; then dense-cache
    decode."""
    jcfg, tcfg, jp, tp = _jax_params("pixtral-12b")
    b, t, n_new = 2, jcfg.num_patches + 5, 2
    toks = rng.integers(1, jcfg.vocab_size, size=(b, t)).astype(np.int32)
    patches = rng.normal(size=(b, jcfg.num_patches, jcfg.frontend_dim))
    patches = patches.astype(np.float32)
    jl, jc = japi.prefill_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                        "patch_embeds": jnp.asarray(patches)})
    tl, tc = tapi.prefill_fn(tp, tcfg, {"tokens": _t(toks).long(),
                                        "patch_embeds": _t(patches)})
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), _np(jc["v"]), **TOL)
    zeros = {"tokens": _t(toks).long(), "patch_embeds": _t(0 * patches)}
    no_patches, _ = tapi.prefill_fn(tp, tcfg, zeros)
    assert not np.allclose(no_patches.numpy(), tl.numpy())
    jc = japi.pad_cache(jcfg, jc, t + n_new)
    tc = tapi.pad_cache(tcfg, tc, t + n_new)
    nxt = np.argmax(_np(jl), -1).astype(np.int32)
    for i in range(n_new):
        pos = np.full((b,), t + i, np.int32)
        jl, jc = japi.decode_fn(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.asarray(pos))
        tl, tc = tapi.decode_fn(tp, tcfg, _t(nxt).long(), tc, _t(pos).long())
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        nxt = np.argmax(_np(jl), -1).astype(np.int32)


def test_plain_attention_prefill_matches_default(rng):
    """Passing the plain chunked attention gives the same prefill as the
    default flash-prefill op (its plain version, on the CPU)."""
    _, tcfg, _, tp = _jax_params("qwen3-1.7b")
    toks = torch.from_numpy(rng.integers(1, tcfg.vocab_size, size=(1, 21)))
    a, ca = tapi.prefill_fn(tp, tcfg, {"tokens": toks})
    b, cb = tapi.prefill_fn(tp, tcfg, {"tokens": toks},
                            attention=tcm.plain_prefill_attention)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(ca["k"], cb["k"])


def test_torch_init_matches_jax_tree():
    """The port's own initializer builds the JAX tree: same keys, shapes and
    dtypes, and the normal leaves have the JAX fan-in scales, for every
    family (moe with and without a shared expert, vlm's vision projection,
    the hybrid's groups, whisper's encoder and decoder stacks)."""
    for name in ("qwen3-1.7b", "mistral-small-24b", "qwen3-moe-30b-a3b",
                 "kimi-k2-1t-a32b", "pixtral-12b", "minicpm-2b",
                 "mamba2-780m", "recurrentgemma-9b", "whisper-small"):
        jcfg, tcfg, jp, _ = _jax_params(name)
        gen = torch.Generator("cpu").manual_seed(0)
        tp = tapi.init_params(tcfg, gen, "cpu")
        flat_j = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_flatten_with_path(jp)[0]}
        flat_t = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_flatten_with_path(tp)[0]}
        assert flat_j.keys() == flat_t.keys()
        for k, v in flat_j.items():
            assert tuple(flat_t[k].shape) == v.shape, k
            assert str(flat_t[k].dtype).split(".")[-1] == str(v.dtype), k
            np.testing.assert_allclose(float(flat_t[k].float().std()),
                                       float(np.std(np.asarray(v))),
                                       rtol=0.1, atol=1e-6, err_msg=k)


def test_init_cache_and_pad_cache_match_jax():
    jcfg = jconfigs.get("mistral-small-24b").reduced()
    tcfg = tconfigs.get("mistral-small-24b").reduced()
    jc = japi.init_cache(jcfg, 2, 9, dtype=jnp.float32)
    tc = tapi.init_cache(tcfg, 2, 9, dtype=torch.float32, device="cpu")
    assert {k: v.shape for k, v in jc.items()} == \
        {k: tuple(v.shape) for k, v in tc.items()}
    for n in (5, 12):
        jp = japi.pad_cache(jcfg, jc, n)
        tp = tapi.pad_cache(tcfg, tc, n)
        assert tuple(tp["k"].shape) == jp["k"].shape
