"""The dry run's steps for every family, and the port's ``act_shard``
sites against the JAX package's, on the CPU: every reduced family runs its
train, prefill and decode steps as DTensors on a fake 2 x 2 mesh, and every
activation the reference constrains is marked in the port with the same
logical names. (The rest of the dry-run tooling is held in
tests/test_torch_dryrun.py.)
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_host_mesh  # noqa: E402,E501
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402

ARCHS = tconfigs.ARCH_IDS


def _cell(arch, kind, data, model, t=128, b=4):
    with fake_process_group(data * model):
        mesh = make_host_mesh(data, model)
        counter, state, inputs, _ = dryrun.lower_cell(
            tconfigs.get(arch).reduced(), ShapeConfig("t", t, b, kind), mesh)
    return counter


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_runs_every_step_sharded(arch):
    """Reduced configs, 2 x 2 fake mesh: train (forward, backward, AdamW),
    prefill and decode all find a placement for every op and run
    collectives."""
    for kind in ("train", "prefill", "decode"):
        counter = _cell(arch, kind, 2, 2, t=64)
        assert counter.flops > 0 and counter.collectives.count > 0, kind


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-moe-30b-a3b",
                                  "mamba2-780m", "recurrentgemma-9b",
                                  "whisper-small", "pixtral-12b"])
def test_act_shard_sites_carry_the_references_names(arch):
    """Every activation the reference constrains is marked in the port with
    the same logical names and shape, and nothing else is: the (names,
    shape) pairs of one prefill (with the dry run's plain attention), decode
    and train step through each package, recorded by an installed rule."""
    from repro.models import common as jcm
    from repro.train.step import make_train_step as jtrain
    from repro_torch.train.step import make_train_step as ttrain
    jcfg, tcfg = jconfigs.get(arch).reduced(), tconfigs.get(arch).reduced()
    b, t = 2, 64
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab_size, (b, t)).astype(np.int32)
    extra = {}
    if jcfg.family == "audio":
        extra["frames"] = rng.normal(size=(b, jcfg.encoder_seq_len,
                                           jcfg.frontend_dim))
    if jcfg.family == "vlm":
        extra["patch_embeds"] = rng.normal(size=(b, jcfg.num_patches,
                                                 jcfg.frontend_dim))
    seen = {"repro": set(), "repro_torch": set()}

    def rec(pkg):
        def fn(x, logical):
            seen[pkg].add((tuple(logical), tuple(x.shape)))
            return x
        return fn

    jcm.set_activation_rules(rec("repro"))
    try:
        import jax.numpy as jnp
        from repro.train.optimizer import AdamW as JAdamW
        from repro.train.optimizer import cosine_schedule as jcos
        from repro.train.step import init_train_state as jinit
        params, _ = japi.init_params(jcfg, jax.random.key(0))
        batch = {"tokens": jnp.asarray(tok),
                 **{k: jnp.asarray(v, jnp.float32) for k, v in extra.items()}}
        _, cache = japi.prefill_fn(params, jcfg, batch)
        cache = japi.pad_cache(jcfg, cache, t + 4)
        japi.decode_fn(params, jcfg, jnp.asarray(tok[:, -1]), cache,
                       jnp.full((b,), t, jnp.int32))
        opt = JAdamW(jcos(1e-3, 2, 20))
        state, _ = jinit(jcfg, opt, jax.random.key(0))
        jtrain(jcfg, opt)(state, {**batch, "labels": jnp.asarray(tok)})
    finally:
        jcm.set_activation_rules(None)
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state
    tcm.set_activation_rules(rec("repro_torch"))
    try:
        params = tapi.init_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
        batch = {"tokens": torch.from_numpy(tok),
                 **{k: torch.tensor(v, dtype=torch.float32)
                    for k, v in extra.items()}}
        _, cache = tapi.prefill_fn(params, tcfg, batch,
                                   tcm.plain_prefill_attention)
        cache = tapi.pad_cache(tcfg, cache, t + 4)
        tapi.decode_fn(params, tcfg, torch.from_numpy(tok[:, -1]), cache,
                       torch.full((b,), t, dtype=torch.int32))
        opt = AdamW(cosine_schedule(1e-3, 2, 20))
        state = init_train_state(tcfg, opt, torch.Generator().manual_seed(0),
                                 "cpu")
        ttrain(tcfg, opt)(state, {**batch, "labels": torch.from_numpy(tok)})
    finally:
        tcm.set_activation_rules(None)
    assert seen["repro_torch"] == seen["repro"]
