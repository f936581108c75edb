"""Roofline step-cost model.

Engine step *timing* on the serving stack's virtual clock comes from a
three-term roofline over the target hardware: compute = FLOPs / peak, memory = bytes / HBM_bw,
collective = bytes / link_bw (tensor-parallel all-reduces). A configurable
MFU-style efficiency derates peak compute. The paper's two benchmark nodes
(GPU-S = 2×L40S tp2, GPU-L = 1×H100) and TPU v5e are all expressible.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.config import HardwareConfig, ModelConfig


@dataclass
class RooflineCost:
    cfg: ModelConfig
    hw: HardwareConfig
    tp: int = 1                      # tensor-parallel degree (chips)
    efficiency: float = 0.45         # fraction-of-peak for dense matmuls
    hbm_efficiency: float = 0.70     # achievable fraction of HBM bandwidth
    step_overhead: float = 2.5e-3    # host/dispatch/framework per step
    bytes_per_param: float = 2.0     # bf16 weights

    def __post_init__(self):
        self.n_params = self.cfg.num_params()
        self.n_active = self.cfg.num_active_params()
        kvh = max(self.cfg.num_kv_heads, 1)
        self.kv_bytes_per_token = (
            2 * self.cfg.num_layers * kvh * max(self.cfg.head_dim, 1) * 2)

    # ------------------------------------------------------------------
    def _time(self, flops, hbm_bytes, coll_bytes):
        chips = self.tp
        t_compute = flops / (chips * self.hw.peak_flops_bf16 * self.efficiency)
        t_memory = hbm_bytes / (chips * self.hw.hbm_bandwidth
                                * self.hbm_efficiency)
        t_coll = (coll_bytes / self.hw.link_bandwidth) if chips > 1 else 0.0
        return max(t_compute, t_memory, t_coll) + self.step_overhead

    def prefill_time(self, new_tokens: int, ctx_len: int) -> float:
        """One chunked-prefill step of `new_tokens`, attending to ctx_len."""
        flops = 2.0 * self.n_active * new_tokens
        flops += (2.0 * 2 * self.cfg.num_layers * self.cfg.num_heads
                  * max(self.cfg.head_dim, 1) * new_tokens * ctx_len)
        hbm = self.n_params * self.bytes_per_param \
            + ctx_len * self.kv_bytes_per_token
        # TP all-reduce of activations: 2 per layer, d_model each token
        coll = (2 * self.cfg.num_layers * new_tokens * self.cfg.d_model
                * 2 * (self.tp - 1) / max(self.tp, 1)) if self.tp > 1 else 0.0
        return self._time(flops, hbm, coll)

    def decode_time(self, batch: int, total_ctx: int) -> float:
        """One decode step for `batch` sequences with summed context
        `total_ctx` tokens (paged KV reads)."""
        flops = 2.0 * self.n_active * batch
        hbm = self.n_params * self.bytes_per_param \
            + total_ctx * self.kv_bytes_per_token
        coll = (2 * self.cfg.num_layers * batch * self.cfg.d_model
                * 2 * (self.tp - 1) / max(self.tp, 1)) if self.tp > 1 else 0.0
        return self._time(flops, hbm, coll)

    def mixed_time(self, new_tokens: int, ctx_len: int, batch: int,
                   total_ctx: int) -> float:
        """One vLLM-v1 mixed step: a prefill chunk of `new_tokens`
        (attending to ctx_len) batched together with `batch` decode tokens.
        Weights stream from HBM once for the whole step."""
        flops = 2.0 * self.n_active * (new_tokens + batch)
        flops += (2.0 * 2 * self.cfg.num_layers * self.cfg.num_heads
                  * max(self.cfg.head_dim, 1) * new_tokens * ctx_len)
        hbm = self.n_params * self.bytes_per_param \
            + (ctx_len + total_ctx) * self.kv_bytes_per_token
        toks = new_tokens + batch
        coll = (2 * self.cfg.num_layers * toks * self.cfg.d_model
                * 2 * (self.tp - 1) / max(self.tp, 1)) if self.tp > 1 else 0.0
        return self._time(flops, hbm, coll)
