"""The graphed dense and moe decode's host side on the CPU: the bucket
ladder (``paged_model.decode_buckets`` / ``decode_bucket``), the families
``DecodeGraphs`` refuses, and a CPU executor, which captures nothing and
keeps the allocator's pool. The graphs themselves are tested on the card
(``tests/test_torch_cuda.py``)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.engine import paged_model  # noqa: E402
from repro_torch.engine.request import Request, SamplingParams  # noqa: E402
from repro_torch.launch import drive  # noqa: E402
from repro_torch.models import api  # noqa: E402


@pytest.mark.parametrize("cap", [1, 2, 4, 5, 8, 12, 64, 256])
def test_bucket_is_the_smallest_that_holds_the_batch(cap):
    buckets = paged_model.decode_buckets(cap)
    assert buckets[0] == 1 and buckets[-1] == cap
    assert list(buckets) == sorted(set(buckets))
    # steps of at most 8 rows, or a quarter of the bucket stepped from
    assert all(b - a <= max(8, a // 4) for a, b in zip(buckets, buckets[1:]))
    for s in range(1, cap + 1):
        b = paged_model.decode_bucket(s, cap)
        assert b in buckets and b >= s
        assert all(c < s for c in buckets if c < b)
    for s in (0, cap + 1, cap + 3):
        with pytest.raises(ValueError):
            paged_model.decode_bucket(s, cap)


def test_ladder_at_the_cells_cap():
    """256 sequences (the chat cell's ``max_num_seqs``): 19 graphs; a batch
    of 45 pads to 48, one of 65 to 80."""
    buckets = paged_model.decode_buckets(256)
    assert buckets == (1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112,
                       128, 160, 192, 224, 256)
    assert paged_model.decode_bucket(45, 256) == 48
    assert paged_model.decode_bucket(65, 256) == 80
    with pytest.raises(ValueError):
        paged_model.decode_bucket(257, 256)


@pytest.mark.parametrize("name", ["mistral-small-24b", "qwen3-moe-30b-a3b"])
def test_cpu_executor_captures_nothing(name):
    """On the CPU every decode is eager: no graphs, ``graph_decodes`` 0, and
    the pool at the allocator's ``num_blocks``, as the reference's."""
    cfg = configs.get(name).reduced()
    params = api.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                             "cpu")
    engine = drive.build_engine(cfg, params, "cpu", num_blocks=64,
                                block_size=16, max_num_seqs=4,
                                max_prefill_tokens=64, max_model_len=256)
    prompts = drive.make_prompts(cfg.vocab_size, (9, 30, 17), seed=3)
    for p in prompts:
        engine.add_request(Request(prompt_tokens=p, sampling=SamplingParams(
            temperature=0.0, max_new_tokens=4)), 0.0)
    while engine.has_work():
        engine.step(0.0)
    ex = engine.executor
    assert ex.graphs is None
    assert ex.decode_steps > 0 and ex.graph_decodes == 0
    assert tuple(ex.pool["k"].shape) == (cfg.num_layers, 64, 16,
                                         cfg.num_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("name", ["mamba2-780m", "recurrentgemma-9b"],
                         ids=["ssm", "hybrid"])
def test_graphs_refuse_the_slot_state_families(name):
    """The slot-state families have no paged pool to capture against:
    ``DecodeGraphs`` refuses them by their family, before it reads the pool
    or touches a device (it is handed none here)."""
    cfg = configs.get(name).reduced()
    with pytest.raises(ValueError, match=cfg.family):
        paged_model.DecodeGraphs(None, cfg, None, max_slots=4, mb=8,
                                 scratch=0)
