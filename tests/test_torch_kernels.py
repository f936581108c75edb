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


@pytest.mark.parametrize("op", ["paged", "flash"])
def test_cpu_dispatch_of_bf16_never_builds_the_kernel(op, rng, monkeypatch):
    """bf16 CPU tensors (the main path's q) take the plain version too, with
    head widths the bf16 kernels would refuse, and keep their dtype."""
    from repro_torch.kernels import build

    def refuse(*_a, **_k):
        raise AssertionError("kernel build reached on the CPU")

    monkeypatch.setattr(build, "load", refuse)
    if op == "paged":
        q, pk, pv, bt, lens = map(torch.from_numpy,
                                  _paged_inputs(rng, 2, 4, 2, 48, 4, 2))
        out = pa_ops.paged_attention(q.bfloat16(), pk, pv, bt, lens)
    else:
        x = torch.from_numpy(rng.normal(size=(1, 5, 2, 80)).astype(np.float32))
        out = fp_ops.flash_prefill(*(x.bfloat16(),) * 3)
    assert out.dtype == torch.bfloat16


# --------------------------------------------------------------------------
# host-side planning of the CUDA wrappers (pure Python, no card needed)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,h,kv,d,bs,mb", [
    (4, 32, 8, 128, 16, 256),   # the main path: mistral-small-24b
    (3, 9, 3, 64, 16, 5),       # QPK 3, fewer pages than one span
    (1, 16, 1, 128, 32, 16),    # MQA, QPK 16
    (5, 32, 32, 96, 16, 300),   # phi3-like head_dim, MB not a multiple
    (2, 4, 2, 64, 512, 3),      # a page longer than the span
])
def test_paged_plan_splits_and_scratch(s, h, kv, d, bs, mb):
    """Whole pages per split, splits cover the table exactly once, and the
    scratch holds one (max, sum) pair and one accumulator per split and
    head: all from the shapes alone."""
    from repro_torch.kernels.paged_attention.kernel import SPAN_TOKENS, plan
    p = plan(s, h, kv, d, bs, mb)
    assert p.span_pages == max(1, SPAN_TOKENS // bs)
    assert p.splits * p.span_pages >= mb > (p.splits - 1) * p.span_pages
    # (max, sum) of shape (S, H, splits, 2), then accumulators (S, H, splits, D)
    assert p.scratch_numel == s * h * p.splits * 2 + s * h * p.splits * d


def test_paged_plan_main_path_fills_the_card():
    """At the main path's shape the split grid has several blocks per SM of
    an H100 (132), where one block per (sequence, KV head) had 32."""
    from repro_torch.kernels.paged_attention.kernel import plan
    s, kv = 4, 8
    p = plan(s, 32, kv, 128, 16, 256)
    assert p.splits * kv * s >= 2 * 132     # the grid (splits, KV, S)


@pytest.mark.parametrize("h,kv,d", [(8, 2, 80), (32, 1, 128), (8, 2, 48),
                                    (6, 4, 64)])
def test_paged_plan_rejects_shapes_the_kernel_does_not_take(h, kv, d):
    from repro_torch.kernels.paged_attention.kernel import plan
    with pytest.raises(ValueError):
        plan(2, h, kv, d, 16, 4)


@pytest.mark.parametrize("t", [1, 37, 63, 64, 65, 300, 1500, 2049])
@pytest.mark.parametrize("h,kv,d", [(32, 8, 128), (9, 3, 64), (16, 1, 96),
                                    (4, 4, 64), (64, 1, 128)])
def test_flash_plan_tiles_cover_every_position(t, h, kv, d):
    """64-row tiles of 64 // QPK positions times QPK heads, rows past that
    dead; just enough tiles for T. Both kernels take the same tiling."""
    from repro_torch.kernels.flash_prefill.kernel import plan
    b = 2
    p = plan(b, t, h, kv, d, torch.bfloat16)
    qpk = h // kv
    assert p.positions == 64 // qpk and 64 - qpk < p.positions * qpk <= 64
    assert (p.q_tiles - 1) * p.positions < t <= p.q_tiles * p.positions
    assert plan(b, t, h, kv, d, torch.float32) == p


@pytest.mark.parametrize("d", [32, 80, 160, 256])
def test_flash_plan_bf16_takes_only_the_configs_head_widths(d):
    """bf16 takes D 64, 96, 128 and 256, the head widths of every config;
    any other raises rather than taking the CUDA-core kernel. f32 takes
    them all."""
    from repro_torch.kernels.flash_prefill.kernel import plan
    if d == 256:   # recurrentgemma-9b's heads
        assert plan(1, 10, 4, 2, d, torch.bfloat16) == plan(
            1, 10, 4, 2, 64, torch.bfloat16)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            plan(1, 10, 4, 2, d, torch.bfloat16)
    assert plan(1, 10, 4, 2, d, torch.float32) == plan(1, 10, 4, 2, 64,
                                                          torch.bfloat16)


def test_flash_plan_head_widths_match_the_configs():
    """Every config with attention has a bf16 flash-prefill width; every
    config of the paged path a paged-decode width and QPK."""
    from repro_torch import configs
    from repro_torch.kernels.flash_prefill.kernel import WGMMA_HEAD_DIMS
    from repro_torch.kernels.paged_attention.kernel import (HEAD_DIMS,
                                                            MAX_Q_PER_KV)
    for cfg in configs.CONFIGS.values():
        if cfg.num_heads:
            assert cfg.head_dim in WGMMA_HEAD_DIMS, cfg.name
        if cfg.family in ("dense", "vlm", "moe"):
            assert cfg.head_dim in HEAD_DIMS and cfg.q_per_kv <= MAX_Q_PER_KV
    assert {c.family for c in configs.CONFIGS.values()
            if not c.num_heads} == {"ssm"}


@pytest.mark.parametrize("bad", ["dtype", "heads"])
def test_flash_plan_rejects_bad_inputs(bad):
    from repro_torch.kernels.flash_prefill.kernel import plan
    with pytest.raises(ValueError):
        if bad == "dtype":
            plan(1, 10, 4, 2, 64, torch.float16)
        else:
            plan(1, 10, 6, 4, 64, torch.bfloat16)
