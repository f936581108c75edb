"""Model and hardware configuration for the PyTorch port.

A copy of the serving subset of the JAX package's ``config.py``. One frozen
dataclass covers every architecture family; family-specific fields default
to None/0 and are only read by the matching model module.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


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
