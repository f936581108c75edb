"""Model and hardware configuration for the PyTorch port.

A copy of the JAX package's ``config.py`` without the dry-run shapes: the
model and hardware configurations, and the control plane's SLO targets and
service knobs. One frozen dataclass covers every architecture family;
family-specific fields default to None/0 and are only read by the matching
model module.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    max_position_embeddings: int = 131_072

    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    router_aux_loss_coef: float = 0.001

    # hybrid (griffin / recurrentgemma): repeating block pattern, e.g.
    # ("rec", "rec", "attn"); local attention window for "attn" layers.
    block_pattern: tuple = ()
    attn_window: int = 0
    rnn_width: int = 0          # RG-LRU recurrence width (== d_model * expand)
    conv_kernel: int = 4

    # ssm (mamba2 / SSD)
    ssm_state_size: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 256

    # enc-dec (whisper): encoder stack dims (decoder uses the main fields)
    encoder_layers: int = 0
    encoder_seq_len: int = 0     # precomputed frame count (conv frontend stub)
    frontend_dim: int = 0        # stub embedding feature size

    # vlm (pixtral): patch-embedding stub
    num_patches: int = 0         # image patches prepended to the sequence

    # numerics
    param_dtype: str = "float32"
    activation_dtype: str = "float32"

    # derived -------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if serve-time attention cost does not grow with context."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def num_params(self) -> int:
        """Analytic parameter count (matches init shapes; used for roofline)."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        n_attn_layers, n_rec_layers, n_ssm_layers = self._layer_split()
        # attention block
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        if self.qk_norm:
            attn += 2 * hd
        # dense mlp (swiglu: gate+up+down)
        mlp = 3 * d * self.d_ff
        if self.family == "moe":
            mlp = self.num_experts * 3 * d * self.moe_d_ff \
                + self.num_shared_experts * 3 * d * self.moe_d_ff \
                + d * self.num_experts  # router
        norms = 2 * d
        total = emb
        total += n_attn_layers * (attn + mlp + norms)
        if n_rec_layers:
            # RG-LRU block: in/gate/out proj + block-diagonal gates + conv
            w = self.rnn_width
            rec = 3 * d * w + 2 * w * w // max(self.num_heads, 1) \
                + (self.conv_kernel + 4) * w
            total += n_rec_layers * (rec + mlp + norms)
        if n_ssm_layers:
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            zxbcdt = d * (2 * d_in + 2 * self.ssm_n_groups * self.ssm_state_size + nheads)
            ssm = zxbcdt + self.conv_kernel * (d_in + 2 * self.ssm_n_groups * self.ssm_state_size) \
                + nheads * 2 + d_in * d + d_in  # A_log, D, out proj, norm
            total += n_ssm_layers * (ssm + 2 * d)
        if self.is_encoder_decoder:
            # encoder: self-attn + mlp per layer, plus decoder cross-attn
            total += self.encoder_layers * (attn + mlp + norms)
            total += self.num_layers * (attn + d)  # cross attention + norm
            total += self.frontend_dim * d  # stub frontend projection
        total += d  # final norm
        return total

    def num_active_params(self) -> int:
        """Active params per token (= num_params for dense)."""
        if self.family != "moe":
            return self.num_params()
        d = self.d_model
        full = self.num_params()
        all_experts = self.num_layers * self.num_experts * 3 * d * self.moe_d_ff
        active = self.num_layers * self.num_experts_per_tok * 3 * d * self.moe_d_ff
        return full - all_experts + active

    def _layer_split(self):
        """(attention_layers, recurrent_layers, ssm_layers) out of num_layers."""
        if self.family == "ssm":
            return 0, 0, self.num_layers
        if self.family == "hybrid":
            n = self.num_layers
            pat = self.block_pattern or ("rec", "rec", "attn")
            reps = [pat[i % len(pat)] for i in range(n)]
            return reps.count("attn"), reps.count("rec"), 0
        return self.num_layers, 0, 0

    # reduced config for CPU smoke tests ----------------------------------
    def reduced(self) -> "ModelConfig":
        changes = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=4 if self.num_kv_heads == self.num_heads else
            (1 if self.num_kv_heads == 1 else 2),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            max_position_embeddings=1024,
            param_dtype="float32",
            activation_dtype="float32",
        )
        if self.family == "moe":
            changes.update(num_experts=8, num_experts_per_tok=2, moe_d_ff=64)
        if self.family == "hybrid":
            changes.update(num_layers=3, rnn_width=256, attn_window=64)
        if self.family == "ssm":
            changes.update(ssm_state_size=16, ssm_head_dim=16, ssm_chunk=32)
        if self.is_encoder_decoder:
            changes.update(encoder_layers=2, encoder_seq_len=64, frontend_dim=80)
        if self.num_patches:
            changes.update(num_patches=16, frontend_dim=64)
        return replace(self, **changes)


@dataclass(frozen=True)
class SLOTarget:
    """Latency targets for one request SLO class: a request *attains* its
    SLO when both its TTFT and its end-to-end latency land under target.
    These are the denominators of the benchmark harness's SLO-attainment
    metric and the per-class weights of the `slo_cost` routing policy."""
    ttft: float          # seconds to first token
    e2el: float          # seconds to last token


#: request-level SLO classes (latency-target tiers, not priority ints):
#: `interactive` is a human waiting at a chat box, `standard` the default
#: API call, `batch` offline bulk work that only cares about completion.
SLO_CLASSES = ("interactive", "standard", "batch")

DEFAULT_SLO_TARGETS = {
    "interactive": SLOTarget(ttft=2.0, e2el=60.0),
    "standard": SLOTarget(ttft=10.0, e2el=300.0),
    "batch": SLOTarget(ttft=60.0, e2el=1800.0),
}

#: per-class SLO attainment objectives — the error-budget denominators of
#: the burn-rate evaluator (repro_torch.core.telemetry): burn = miss_fraction /
#: (1 - objective).  Batch tolerates a wider budget: it is the class the
#: gateway sheds first under overload.
DEFAULT_SLO_OBJECTIVES = {
    "interactive": 0.99,
    "standard": 0.99,
    "batch": 0.95,
}


@dataclass(frozen=True)
class ServiceConfig:
    """Control-plane service knobs (paper §3.1–3.3 plus the routing and
    queuing extensions from the production-stack proposals).

    routing_policy selects the Web Gateway's endpoint-selection strategy
    (see repro_torch.core.router.POLICIES). queue_capacity > 0 enables bounded
    router-side request queuing: requests that would be rejected 461 are
    held up to queue_ttl seconds and drained when an instance comes up.
    Dequeue is priority-ordered (Request.priority, FIFO within a class);
    queue_aging is the starvation-avoidance knob — priority points a
    queued request gains per second of waiting (0 = strict priority).
    retry_after_cooldown is the Retry-After hint stamped on 461/462 wire
    errors when queuing is disabled — the autoscaler scale-up cooldown
    analogue (with queuing enabled the hint is queue_ttl instead).
    """
    routing_policy: str = "round_robin"
    affinity_replicas: int = 64        # virtual nodes per endpoint (ring)
    prefix_tokens: int = 32            # prefix-aware grouping key length
    queue_capacity: int = 0            # 0 = disabled (seed behaviour)
    queue_ttl: float = 30.0            # seconds before a queued req expires
    queue_drain_interval: float = 1.0  # periodic expiry/drain tick
    queue_aging: float = 0.0           # priority points per queued second
    # weighted fair queuing across tenants in the gateway queue (one
    # bucket per authenticated tenant, service measured in tokens over
    # TenantSpec.weight); False = single per-model bucket (plain
    # priority-FIFO, the PR-3 behaviour) — the benchmark baseline
    fair_queuing: bool = True
    retry_after_cooldown: float = 60.0  # 461/462 retry hint, queue disabled
    # gateway auth cache: bound on cached keys (LRU beyond it) and the
    # short TTL for cached *negative* lookups — an attacker hammering bad
    # keys must not buy a DB trip per probe nor grow the cache unboundedly
    auth_cache_max: int = 1024
    auth_neg_ttl: float = 5.0
    # admission control: when queuing, reject-early (461 + retry_after)
    # any request whose roofline-estimated service time already exceeds
    # the queue TTL it would be held under — it could never be served
    # within its budget, so fail fast instead of parking a doomed request
    admission_control: bool = False
    # default prefill->decode KV handoff link (bytes/s) for disaggregated
    # models configured outside the declarative spec path
    kv_transfer_bandwidth: float = 40e9
    # per-class latency targets: the SLO-attainment denominators and the
    # slo_cost router's per-request weighting (keys must be SLO_CLASSES)
    slo_targets: dict = field(
        default_factory=lambda: dict(DEFAULT_SLO_TARGETS))
    # distributed request tracing (repro_torch.core.tracing): span trees are
    # recorded for every request when enabled; trace_sample_rate is the
    # head-based RETENTION probability (errors and SLO-misses are always
    # retained), overridable per tenant, and trace_max_retained bounds
    # the in-memory trace store (oldest evicted first)
    tracing_enabled: bool = True
    trace_sample_rate: float = 1.0
    tenant_trace_sample_rates: dict = field(default_factory=dict)
    trace_max_retained: int = 1024
    # SLO burn-rate telemetry (repro_torch.core.telemetry): rollup store +
    # multi-window multi-burn-rate alert evaluator over per-class SLO
    # attainment.  Each severity pair is (short_window_s, long_window_s)
    # + the burn factor both windows must exceed to fire (Google SRE
    # workbook ch. 5 defaults scaled to the simulation's minutes-long
    # runs); burn_min_events suppresses alerts on tiny samples.  The
    # evaluator is fed by the tracer, so it goes dark when
    # tracing_enabled is off.
    telemetry_enabled: bool = True
    slo_objectives: dict = field(
        default_factory=lambda: dict(DEFAULT_SLO_OBJECTIVES))
    burn_fast_window: tuple = (30.0, 120.0)
    burn_fast_factor: float = 14.4
    burn_slow_window: tuple = (120.0, 600.0)
    burn_slow_factor: float = 6.0
    burn_min_events: int = 8
    # per-class admission shedding while a fast-burn alert fires: the
    # gateway answers 461 (+ projected-recovery retry_after) for batch
    # first, escalating one class per shed_escalate_after seconds of
    # sustained firing; interactive is never shed.  Default OFF — it is
    # a policy decision, not an observability feature.
    slo_shed_enabled: bool = False
    shed_escalate_after: float = 60.0


@dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell: an input shape + which step it lowers."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class HardwareConfig:
    """Roofline constants for a chip + interconnect."""
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    hbm_bandwidth: float        # bytes/s per chip
    link_bandwidth: float       # bytes/s per chip (ICI / NVLink / IB share)
    hbm_bytes: float

    def step_time(self, flops: float, bytes_hbm: float, bytes_coll: float = 0.0,
                  efficiency: float = 1.0) -> float:
        """Roofline step-time estimate: max of the three terms."""
        return max(flops / (self.peak_flops_bf16 * efficiency),
                   bytes_hbm / self.hbm_bandwidth,
                   bytes_coll / self.link_bandwidth if self.link_bandwidth else 0.0)


TPU_V5E = HardwareConfig("tpu-v5e", 197e12, 819e9, 50e9, 16e9)
# Paper's two benchmark configurations (Table 1); dense-bf16 peaks
# (the 2x "with sparsity" datasheet figures halved where applicable).
GPU_L40S = HardwareConfig("l40s", 181e12, 864e9, 64e9, 48e9)
GPU_H100 = HardwareConfig("h100-sxm", 989e12, 3350e9, 450e9, 80e9)

HARDWARE = {h.name: h for h in (TPU_V5E, GPU_L40S, GPU_H100)}
