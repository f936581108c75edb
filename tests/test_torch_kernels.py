"""The port's kernel ops on the CPU (their plain PyTorch versions) against
the JAX package's Pallas kernels in interpret mode and its jnp oracles, on
the same inputs made from a seed with numpy."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_prefill.kernel import flash_prefill as jax_flash  # noqa: E402
from repro.kernels.flash_prefill.ref import flash_prefill_ref as jax_flash_ref  # noqa: E402
from repro.kernels.paged_attention.kernel import paged_attention as jax_paged  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref  # noqa: E402
from repro.models.common import chunked_causal_mha as jax_chunked  # noqa: E402
from repro_torch.kernels.flash_prefill import ops as fp_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 on both sides, as tests/test_kernels.py


def _paged_inputs(rng, s, h, kv, d, bs, mb):
    nb = s * mb + 1
    return (rng.normal(size=(s, h, d)).astype(np.float32),
            rng.normal(size=(nb, bs, kv, d)).astype(np.float32),
            rng.normal(size=(nb, bs, kv, d)).astype(np.float32),
            rng.integers(0, nb, size=(s, mb)).astype(np.int32),
            rng.integers(1, mb * bs + 1, size=(s,)).astype(np.int32))


@pytest.mark.parametrize("s,h,kv,d,bs,mb", [
    (3, 4, 4, 64, 8, 4),      # QPK 1
    (2, 4, 2, 96, 8, 3),      # QPK 2, phi3-like head_dim
    (2, 9, 3, 64, 4, 5),      # QPK 3 (smollm-like)
])
def test_paged_attention_matches_jax(s, h, kv, d, bs, mb, rng):
    args = _paged_inputs(rng, s, h, kv, d, bs, mb)
    out = pa_ops.paged_attention(*map(torch.from_numpy, args)).numpy()
    ref = np.asarray(jax_paged_ref(*map(jnp.asarray, args)))
    pal = np.asarray(jax_paged(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pal, **TOL)


def test_paged_attention_single_token_context(rng):
    """ctx = 1: only the first slot of the first page takes part."""
    q, pk, pv, bt, _ = _paged_inputs(rng, 2, 4, 2, 64, 8, 3)
    lens = np.ones((2,), np.int32)
    out = pa_ops.paged_attention(*map(torch.from_numpy,
                                      (q, pk, pv, bt, lens))).numpy()
    v0 = np.repeat(pv[bt[:, 0], 0], 2, axis=1)
    np.testing.assert_allclose(out, v0, **TOL)


@pytest.mark.parametrize("b,t,h,kv,d,window,bq,bk", [
    (1, 128, 4, 2, 64, 0, 64, 64),
    (1, 128, 9, 3, 64, 0, 32, 64),     # h=9 / kv=3
    (2, 128, 4, 1, 64, 48, 64, 64),    # windowed
])
def test_flash_prefill_matches_pallas(b, t, h, kv, d, window, bq, bk, rng):
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    out = fp_ops.flash_prefill(*map(torch.from_numpy, (q, k, v)),
                               window=window).numpy()
    pal = jax_flash(*map(jnp.asarray, (q, k, v)), window=window, bq=bq,
                    bk=bk, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pal), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("t,h,kv,window", [
    (37, 9, 3, 0),     # ragged T, GQA 3
    (37, 9, 3, 16),    # ragged T, windowed
    (50, 4, 4, 0),
])
def test_flash_prefill_ragged_matches_refs(t, h, kv, window, rng):
    """Ragged T (the engine's prompt lengths), against the jnp oracle and
    the function the JAX prefill calls."""
    d = 32
    q = rng.normal(size=(1, t, h, d)).astype(np.float32)
    k = rng.normal(size=(1, t, kv, d)).astype(np.float32)
    v = rng.normal(size=(1, t, kv, d)).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = fp_ops.flash_prefill(tq, tk, tv, window=window).numpy()
    ref = np.asarray(jax_flash_ref(*map(jnp.asarray, (q, k, v)), window))
    chunked = np.asarray(jax_chunked(*map(jnp.asarray, (q, k, v)), h // kv,
                                     window))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, chunked, **TOL)
    plain = tcm.plain_prefill_attention(tq, tk, tv, window).numpy()
    np.testing.assert_allclose(plain, chunked, **TOL)


def test_chunked_causal_mha_long_prompt_matches_jax(rng):
    """T above the chunking threshold takes the per-chunk loop."""
    t, h, kv, d = 2 * tcm.ATTN_CHUNK_Q + tcm.ATTN_CHUNK_Q, 2, 1, 8
    q = rng.normal(size=(1, t, h, d)).astype(np.float32)
    k = rng.normal(size=(1, t, kv, d)).astype(np.float32)
    v = rng.normal(size=(1, t, kv, d)).astype(np.float32)
    out = tcm.chunked_causal_mha(*map(torch.from_numpy, (q, k, v)), h // kv,
                                 window=300).numpy()
    ref = np.asarray(jax_chunked(*map(jnp.asarray, (q, k, v)), h // kv, 300))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("op", ["paged", "flash"])
def test_cpu_dispatch_never_builds_the_kernel(op, rng, monkeypatch):
    """A CPU tensor takes the plain version: the kernel's wrapper is never
    reached and its launch count does not move."""
    from repro_torch.kernels import build

    def refuse(*_a, **_k):
        raise AssertionError("kernel build reached on the CPU")

    monkeypatch.setattr(build, "load", refuse)
    if op == "paged":
        from repro_torch.kernels.paged_attention import kernel
        before = kernel.paged_attention.launches
        pa_ops.paged_attention(*map(torch.from_numpy,
                                    _paged_inputs(rng, 2, 4, 2, 32, 4, 2)))
        assert kernel.paged_attention.launches == before
    else:
        from repro_torch.kernels.flash_prefill import kernel
        before = kernel.flash_prefill.launches
        x = torch.from_numpy(rng.normal(size=(1, 5, 2, 32)).astype(np.float32))
        fp_ops.flash_prefill(x, x, x)
        assert kernel.flash_prefill.launches == before
