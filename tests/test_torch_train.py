"""The port's training slice against the JAX package: schedules, AdamW,
the token pipeline, the trainer and its exact resume, and each family's
loss and gradient on the same weights and batches."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.tokens import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.data.tokens import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import griffin, moe  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.loop import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.optimizer import (AdamW, cosine_schedule,  # noqa: E402
                                         global_norm, leaves, wsd_schedule)

# f32 on both sides. The frameworks sum products in different orders, so a
# loss agrees to ~1e-7 relative and a gradient leaf to ~1e-5 of its largest
# entry; the bounds below leave a decade of room.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4          # max |err| <= GRAD_RTOL * max |ref|, per leaf
CURVE_RTOL = 1e-4         # loss curves of the two trainers
ADAM_RTOL = 1e-6          # AdamW's update on equal inputs

# (arch, batch, seq_len) of the reduced configs: hybrid past its window of
# 64, ssm on whole SSD chunks of 32, vlm past its 16 patches
FAMILIES = {"dense": ("smollm-135m", 2, 24),
            "moe": ("qwen3-moe-30b-a3b", 2, 24),
            "ssm": ("mamba2-780m", 2, 64),
            "hybrid": ("recurrentgemma-9b", 2, 96),
            "audio": ("whisper-small", 2, 24),
            "vlm": ("pixtral-12b", 2, 32)}


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# --------------------------------------------------------------------------
# schedules and AdamW (twins of tests/test_train.py)
# --------------------------------------------------------------------------

def test_wsd_schedule_shape():
    lr = wsd_schedule(1e-3, warmup_steps=10, stable_steps=50, decay_steps=20)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1e-3)
    assert float(lr(40)) == pytest.approx(1e-3)       # stable plateau
    assert float(lr(70)) < 2e-4                        # decayed
    assert float(lr(80)) == pytest.approx(1e-5, rel=0.1)


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, 10, 100)
    assert float(lr(5)) == pytest.approx(5e-4)
    assert float(lr(100)) == pytest.approx(1e-4, rel=0.01)


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
def test_schedule_matches_jax(kind):
    """Every step from 0 past the end, as f32 on both sides (rel 1e-6)."""
    if kind == "cosine":
        t, j = cosine_schedule(3e-4, 20, 150), jopt.cosine_schedule(
            3e-4, 20, 150)
    else:
        t = wsd_schedule(6e-4, 20, 105, 30)
        j = jopt.wsd_schedule(6e-4, 20, 105, 30)
    steps = np.arange(0, 170, dtype=np.int32)
    got = t(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j(steps)), rtol=1e-6,
                               atol=0)


def test_adamw_clips_gradients():
    opt = AdamW(lambda s: 1e-3, clip_norm=1.0)
    params = {"w": torch.ones(4)}
    opt_state = opt.init(params)
    grads = {"w": torch.full((4,), 100.0)}
    _, _, metrics = opt.update(grads, opt_state, params)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    # clipped to norm 1 and normalised by Adam: each entry moved by ~lr
    assert float((1 - params["w"]).abs().max()) == pytest.approx(
        1e-3 * (1 + 0.1), rel=1e-3)


def test_adamw_decreases_quadratic():
    opt = AdamW(lambda s: 0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    st = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, st, _ = opt.update(grads, st, params)
    assert float(params["w"].abs().max()) < 0.2


def test_adamw_state_layout():
    """f32 moments whatever the parameter's dtype, a 0-d int32 step."""
    opt = AdamW(cosine_schedule(1e-3, 2, 10))
    st = opt.init({"a": torch.zeros(3, dtype=torch.bfloat16),
                   "b": {"c": torch.zeros(2, 2)}})
    assert st["m"]["a"].dtype == st["v"]["b"]["c"].dtype == torch.float32
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()


def _leaf_close(a, ref, rtol):
    """max |a - ref| <= rtol * max |ref| over the leaf: per-entry relative
    error is meaningless where a moment cancels to near zero."""
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    assert a.shape == ref.shape
    assert float(np.abs(a - ref).max()) <= rtol * float(np.abs(ref).max())


def test_adamw_updates_match_jax(rng):
    """Five updates with clipping, decay and a schedule, from the same
    params and gradients: f32 params and moments to rel 1e-6 of each leaf's
    largest entry, the metrics to rel 1e-6; the bf16 leaf to one bf16 step
    (its f32 update agrees as closely, and the cast can round a tie either
    way)."""
    import ml_dtypes
    shapes = {"w": (4, 6), "layers": {"k": (2, 3, 5)}, "b": (7,)}
    params = {"w": rng.normal(size=(4, 6)).astype(np.float32),
              "layers": {"k": rng.normal(size=(2, 3, 5)).astype(np.float32)},
              "b": rng.normal(size=(7,)).astype(ml_dtypes.bfloat16)}
    jo = jopt.AdamW(jopt.cosine_schedule(1e-2, 2, 6))
    to = AdamW(cosine_schedule(1e-2, 2, 6))
    jp = jax.tree.map(jnp.asarray, params)
    tp = tparams.from_numpy(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for i in range(5):
        scale = 0.5 if i % 2 else 50.0                 # clipped and not
        grads = jax.tree.map(
            lambda s: (scale * rng.normal(size=s)).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
        jp, js, jm = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tm = to.update(tparams.from_numpy(grads, "cpu"), ts, tp)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=ADAM_RTOL)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for key in ("m", "v"):
            for a, b in zip(leaves(ts[key]), jax.tree.leaves(js[key])):
                _leaf_close(a.numpy(), b, ADAM_RTOL)
        _leaf_close(tp["w"].numpy(), jp["w"], ADAM_RTOL)
        _leaf_close(tp["layers"]["k"].numpy(), jp["layers"]["k"], ADAM_RTOL)
        assert tp["b"].dtype == torch.bfloat16
        np.testing.assert_allclose(tp["b"].float().numpy(),
                                   np.asarray(jp["b"], np.float32),
                                   rtol=2 ** -8, atol=0)


def test_global_norm_matches_jax(rng):
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    assert float(global_norm(tparams.from_numpy(tree, "cpu"))) == \
        pytest.approx(float(jopt.global_norm(tree)), rel=1e-6)


# --------------------------------------------------------------------------
# token data
# --------------------------------------------------------------------------

def test_pipeline_deterministic_and_seekable():
    cfg = DataConfig(vocab_size=64, seq_len=32, global_batch=4, seed=1)
    p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
    b7a, b7b = p1.batch(7), p2.batch(7)
    np.testing.assert_array_equal(b7a["tokens"], b7b["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b7a["tokens"][:, 1:], b7a["labels"][:, :-1])
    assert not np.array_equal(p1.batch(8)["tokens"], b7a["tokens"])


@pytest.mark.parametrize("index", [0, 3, 12])
def test_pipeline_matches_jax(index):
    """The copy gives the reference's batches, token for token."""
    from repro.data.tokens import DataConfig as JDataConfig
    kw = dict(vocab_size=512, seq_len=48, global_batch=3, seed=5)
    a = TokenPipeline(DataConfig(**kw)).batch(index)
    b = JTokenPipeline(JDataConfig(**kw)).batch(index)
    for k in ("tokens", "labels"):
        assert a[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# loss and gradients, family by family
# --------------------------------------------------------------------------

def _batch(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(b, cfg.encoder_seq_len, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(family):
    """The reference's loss, metrics and gradient, as numpy, with the
    params and batch it saw."""
    name, b, t = FAMILIES[family]
    jcfg = jconfigs.get(name).reduced()
    params, _ = japi.init_params(jcfg, jax.random.key(3))
    batch = _batch(jcfg, b, t)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, batch), has_aux=True)(params)
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _port_loss_and_grad(family, remat):
    params, batch, *_ = _jax_loss_and_grad(family)
    cfg = configs.get(FAMILIES[family][0]).reduced()
    tp = tparams.from_numpy(params, "cpu")
    flat = [p.requires_grad_() for p in leaves(tp)]
    loss, metrics = api.loss_fn(tp, cfg, {k: _t(v) for k, v in batch.items()},
                                remat=remat)
    grads = torch.autograd.grad(loss, flat)
    return float(loss.detach()), {k: float(v.detach()) for k, v in
                                  metrics.items()}, grads


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grad_match_jax(family, remat):
    _, _, jloss, jmetrics, jgrads = _jax_loss_and_grad(family)
    loss, metrics, grads = _port_loss_and_grad(family, remat)
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL)
    assert metrics["loss"] == pytest.approx(jmetrics["loss"], rel=LOSS_RTOL)
    assert metrics["aux_loss"] == pytest.approx(jmetrics["aux_loss"],
                                                rel=LOSS_RTOL)
    if family == "moe":
        assert metrics["aux_loss"] > 0
    if family == "hybrid":          # the window's edge is reached
        name, _, t = FAMILIES[family]
        assert t > configs.get(name).reduced().attn_window
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(grads) == len(jflat)
    for g, (path, ref) in zip(grads, jflat):
        assert tuple(g.shape) == ref.shape, path
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= GRAD_RTOL * float(np.abs(ref).max()), (path, err)


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "audio"])
def test_remat_changes_nothing(family):
    """Recomputing each layer in the backward pass gives the same loss and
    gradient, bit for bit."""
    a = _port_loss_and_grad(family, True)
    b = _port_loss_and_grad(family, False)
    assert a[0] == b[0]
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)


def test_moe_training_drops_tokens_past_capacity():
    """The moe case above routes with GShard's capacity, and some expert
    receives more entries than it holds: the dropping branch's backward is
    what the gradient twin checks."""
    params, batch, *_ = _jax_loss_and_grad("moe")
    cfg = configs.get(FAMILIES["moe"][0]).reduced()
    tp = tparams.from_numpy(params, "cpu")
    x = cm.embed(tp["embedding"], _t(batch["tokens"]))
    lp = cm.unstack(tp["layers"])[0]
    h = cm.rms_norm(x + cm.attention_train(lp["attn"], cfg, cm.rms_norm(
        x, lp["ln1"], cfg.norm_eps)), lp["ln2"], cfg.norm_eps)
    n = h.shape[0] * h.shape[1]
    probs = torch.softmax((h.reshape(n, -1) @ lp["moe"]["router"]).float(), -1)
    _, top_i = moe.top_k(probs, cfg.num_experts_per_tok)
    counts = torch.bincount(top_i.reshape(-1), minlength=cfg.num_experts)
    cap = moe.capacity(n, cfg.num_experts_per_tok, cfg.num_experts,
                       moe.CAPACITY_FACTOR)
    assert int(counts.max()) > cap


@pytest.mark.parametrize("window", [0, 1000], ids=["causal", "window1000"])
def test_chunked_attention_train_grad_matches_jax(window, rng):
    """Past ATTN_CHUNK_T the attention runs chunk by chunk, each chunk
    recomputed in the backward pass: loss and gradient against jax.grad."""
    jcfg = dataclasses.replace(jconfigs.get("smollm-135m").reduced(),
                               num_heads=2, num_kv_heads=1, head_dim=8,
                               d_model=16)
    tcfg = dataclasses.replace(configs.get("smollm-135m").reduced(),
                               num_heads=2, num_kv_heads=1, head_dim=8,
                               d_model=16)
    t = 3 * jcm.ATTN_CHUNK_Q
    assert t > jcm.ATTN_CHUNK_T
    p = {k: rng.normal(size=s).astype(np.float32) * 0.3 for k, s in
         (("wq", (16, 2, 8)), ("wk", (16, 1, 8)), ("wv", (16, 1, 8)),
          ("wo", (2, 8, 16)))}
    x = rng.normal(size=(1, t, 16)).astype(np.float32)
    w = rng.normal(size=(1, t, 16)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jcm.attention_train(p, jcfg, x, window) * w)

    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(p, x)
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    tl = torch.sum(cm.attention_train(tp, tcfg, tx, window) * _t(w))
    gx, *gp = torch.autograd.grad(tl, [tx] + [tp[k] for k in sorted(tp)])
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    for g, ref in zip([gx] + gp, [jgx] + [jgp[k] for k in sorted(jgp)]):
        ref = np.asarray(ref)
        assert float(np.abs(g.numpy() - ref).max()) <= \
            GRAD_RTOL * float(np.abs(ref).max())


def test_rg_lru_scan_grad_matches_associative_scan(rng):
    """The port's doubling scan against lax.associative_scan, value and
    gradient, at a length that is not a power of two."""
    w = 24
    p = {"gate_x": rng.normal(size=(4, 6, 6)).astype(np.float32) * 0.4,
         "gate_a": rng.normal(size=(4, 6, 6)).astype(np.float32) * 0.4,
         "bias_x": rng.normal(size=(w,)).astype(np.float32) * 0.1,
         "bias_a": rng.normal(size=(w,)).astype(np.float32) * 0.1,
         "lam": np.linspace(0.7, 2.5, w).astype(np.float32)}
    u = rng.normal(size=(2, 77, w)).astype(np.float32)
    c = rng.normal(size=(2, 77, w)).astype(np.float32)
    jl, (jgp, jgu) = jax.value_and_grad(
        lambda p, u: jnp.sum(jgriffin.rg_lru_scan(p, u) * c),
        argnums=(0, 1))(p, u)
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tu = _t(u).requires_grad_()
    tl = torch.sum(griffin.rg_lru_scan(tp, tu) * _t(c))
    gu, *gp = torch.autograd.grad(tl, [tu] + [tp[k] for k in sorted(tp)])
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    for g, ref in zip([gu] + gp, [jgu] + [jgp[k] for k in sorted(jgp)]):
        ref = np.asarray(ref)
        assert float(np.abs(g.numpy() - ref).max()) <= \
            GRAD_RTOL * float(np.abs(ref).max())


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked, rng):
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    ref = jcm.cross_entropy(logits, labels, mask)
    got = cm.cross_entropy(_t(logits), _t(labels),
                           None if mask is None else _t(mask))
    assert float(got) == pytest.approx(float(ref), rel=1e-6)


def test_vlm_loss_masks_the_patch_positions():
    """Without a loss_mask, the vlm loss is the mean over the text
    positions only: changing a label under a patch changes nothing."""
    params, batch, *_ = _jax_loss_and_grad("vlm")
    cfg = configs.get(FAMILIES["vlm"][0]).reduced()
    tp = tparams.from_numpy(params, "cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        a, _ = api.loss_fn(tp, cfg, tb)
        tb["labels"][:, : cfg.num_patches] = (tb["labels"][:, : cfg.num_patches]
                                              + 1) % cfg.vocab_size
        b, _ = api.loss_fn(tp, cfg, tb)
        tb["labels"][:, -1] = (tb["labels"][:, -1] + 1) % cfg.vocab_size
        c, _ = api.loss_fn(tp, cfg, tb)
    assert float(a) == float(b) != float(c)


# --------------------------------------------------------------------------
# step functions and the trainer
# --------------------------------------------------------------------------

def _tcfg(tmp_path, **kw):
    return TrainerConfig(**{**dict(seq_len=64, global_batch=4, steps=14,
                                   ckpt_every=6, ckpt_dir=str(tmp_path),
                                   log_every=100), **kw})


def test_train_step_metrics_and_state(tmp_path):
    cfg = configs.get("smollm-135m").reduced()
    opt = AdamW(cosine_schedule(1e-3, 2, 10))
    state = tstep.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                   "cpu")
    before = state["params"]["final_norm"].clone()
    batch = {k: _t(v) for k, v in TokenPipeline(DataConfig(
        cfg.vocab_size, 16, 2)).batch(0).items()}
    state, metrics = tstep.make_train_step(cfg, opt)(state, batch)
    assert set(metrics) == {"loss", "aux_loss", "grad_norm", "lr"}
    assert all(not v.requires_grad for v in metrics.values())
    assert int(state["opt"]["step"]) == 1
    assert not torch.equal(before, state["params"]["final_norm"])
    assert float(metrics["loss"]) == pytest.approx(np.log(cfg.vocab_size),
                                                   rel=0.05)


def test_serving_step_functions_are_the_model_api():
    cfg = configs.get("smollm-135m").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.arange(5)[None]
    a, cache = tstep.make_prefill_step(cfg)(params, {"tokens": toks})
    b, _ = api.prefill_fn(params, cfg, {"tokens": toks})
    assert torch.equal(a, b)
    cache = api.pad_cache(cfg, cache, 8)
    pos = torch.tensor([5])
    c, _ = tstep.make_decode_step(cfg)(params, torch.tensor([3]),
                                       {k: v.clone() for k, v in cache.items()},
                                       pos)
    d, _ = api.decode_fn(params, cfg, torch.tensor([3]), cache, pos)
    assert torch.equal(c, d)


def test_trainer_learns_and_resumes_exactly(tmp_path):
    cfg = configs.get("smollm-135m").reduced()
    tc = _tcfg(tmp_path)
    tr = Trainer(cfg, tc, device="cpu")
    hist = tr.run(steps=12)           # "crash" right after the step-12 ckpt
    assert hist[-1]["loss"] < hist[0]["loss"], "no learning signal"

    # restart -> resumes at 12 and continues to 14
    tr3 = Trainer(cfg, tc, device="cpu")
    assert tr3.step_idx == 12
    h3 = tr3.run()
    assert tr3.step_idx == 14
    assert np.isfinite(h3[-1]["loss"])

    # exact resume: a run without interruption gives the same numbers
    tc3 = _tcfg(str(tmp_path) + "_b", ckpt_every=1000)
    tr4 = Trainer(cfg, tc3, device="cpu")
    h4 = tr4.run()
    assert [h["loss"] for h in h4[:12]] == [h["loss"] for h in hist]
    assert [h["loss"] for h in h4[12:]] == [h["loss"] for h in h3]
    assert [h["grad_norm"] for h in h4[12:]] == [h["grad_norm"] for h in h3]


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_trainer_matches_the_jax_trainer(family, tmp_path):
    """Both trainers from the same params and data: loss, aux_loss,
    grad_norm and lr curves over 6 steps to rel 1e-4; and each leaf's
    update over the run (after - before) to 5 % of the leaf's largest
    update: Adam divides by sqrt(v), so an entry whose gradient is near
    zero moves by an amount that the frameworks' summation orders change
    by a fair part of one step."""
    name, b, t = FAMILIES[family]
    jcfg = jconfigs.get(name).reduced()
    cfg = configs.get(name).reduced()
    kw = dict(seq_len=t, global_batch=b, steps=6, ckpt_every=1000,
              log_every=100, warmup_steps=2)
    jtr = jloop.Trainer(jcfg, jloop.TrainerConfig(
        ckpt_dir=str(tmp_path / "j"), **kw))
    start = jax.tree.map(np.array, jtr.state["params"])
    jh = jtr.run()
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "t"), **kw),
                 params=tparams.from_numpy(start, "cpu"), device="cpu")
    th = tr.run()
    assert len(th) == len(jh) == 6
    for a, b in zip(th, jh):
        for k in ("loss", "aux_loss", "grad_norm", "lr"):
            assert a[k] == pytest.approx(b[k], rel=CURVE_RTOL), (a["step"], k)
    assert th[-1]["loss"] < th[0]["loss"]
    ref = jax.tree.map(np.asarray, jtr.state["params"])
    for a, b, s0 in zip(leaves(tr.state["params"]), jax.tree.leaves(ref),
                        jax.tree.leaves(start)):
        du, dj = a.detach().numpy() - s0, b - s0
        assert float(np.abs(du - dj).max()) <= 0.05 * float(np.abs(dj).max())


def test_port_resumes_a_jax_trainer_checkpoint(tmp_path):
    """A checkpoint the JAX trainer wrote restores into the port's trainer,
    which then takes the reference's next step."""
    jcfg = jconfigs.get("smollm-135m").reduced()
    cfg = configs.get("smollm-135m").reduced()
    kw = dict(seq_len=32, global_batch=2, steps=4, ckpt_every=3,
              log_every=100, ckpt_dir=str(tmp_path))
    jh = jloop.Trainer(jcfg, jloop.TrainerConfig(**kw)).run()
    tr = Trainer(cfg, TrainerConfig(**kw), device="cpu")
    assert tr.step_idx == 3
    assert int(tr.state["opt"]["step"]) == 3
    th = tr.run()
    assert th[0]["loss"] == pytest.approx(jh[3]["loss"], rel=CURVE_RTOL)


@pytest.mark.parametrize("name", ["pixtral-12b", "whisper-small"])
def test_trainer_refuses_vlm_and_audio(name, tmp_path):
    cfg = configs.get(name).reduced()
    with pytest.raises(ValueError, match="patch_embeds|frames"):
        Trainer(cfg, _tcfg(tmp_path), device="cpu")


def test_trainer_does_not_fall_back_to_cpu(tmp_path, monkeypatch):
    from repro_torch.launch import train as launch_train
    from repro_torch.launch import train_smollm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, _tcfg(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_smollm.main(["--ckpt-dir", str(tmp_path)])


def test_launch_train_on_the_cpu_resumes(tmp_path):
    from repro_torch.launch import train as launch_train
    argv = ["--reduced", "--device", "cpu", "--steps", "3", "--seq-len", "16",
            "--global-batch", "2", "--ckpt-dir", str(tmp_path)]
    hist = launch_train.main(argv)
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    argv[argv.index("3")] = "5"
    assert [h["step"] for h in launch_train.main(argv)] == [3, 4]
