"""Model configuration system for the 10 assigned architectures (the port's
own copy of ``repro.configs.base``: the port imports nothing of the
reference).

One frozen dataclass describes every architecture family the assignment
covers (dense / MoE / SSM / hybrid / enc-dec / VLM backbone).  Per-arch
modules live next to this file (``<arch>.py``), each exporting ``CONFIG``
(the full assigned configuration) and ``SMOKE`` (a reduced same-family
configuration for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "SHAPES", "Shape", "registry", "get_config"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | rwkv6 | griffin | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # defaults to d_model // n_heads

    # layer pattern, cycled: e.g. ("local","global") for gemma2,
    # ("rec","rec","local") for recurrentgemma, ("global",) for llama-likes
    pattern: Tuple[str, ...] = ("global",)
    window: int = 4096               # local-attention window
    softcap_attn: float = 0.0        # gemma2 attn logit soft cap
    softcap_final: float = 0.0       # gemma2 final logit soft cap
    qk_norm: bool = False            # qwen3 / chameleon
    mlp_act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU / plain)
    mlp_gated: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    topk: int = 0
    capacity_factor: float = 1.25

    # encoder-decoder (whisper): n_layers is the decoder depth
    n_enc_layers: int = 0
    enc_seq: int = 1500              # precomputed audio-frame positions (stub)

    # recurrent families
    conv_width: int = 4              # griffin temporal conv
    lru_width: Optional[int] = None  # griffin RG-LRU width (default d_model)

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    # perf levers (hillclimb knobs; see EXPERIMENTS.md §Perf)
    cache_dtype: str = ""        # "" = dtype; "float8_e4m3fn" halves KV bytes
    seq_parallel: bool = False   # shard residual-stream T over model axis
    rwkv_chunk: int = 0          # 0 = token-by-token scan (faster where the
                                 # state fits cache — CPU-measured; see §Perf
                                 # cell c); L = chunk-parallel (MXU form)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to a multiple of 128 (MXU lane alignment + even
        model-axis sharding)."""
        return _round_up(self.vocab, 128)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True when no layer attends over unbounded context (long_500k OK)."""
        return all(k in ("rec", "local", "rwkv") for k in self.pattern)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_padded
        H, KV, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        mlp = D * F * (3 if self.mlp_gated else 2)
        if self.is_moe:
            mlp = mlp * self.n_experts + D * self.n_experts  # + router
        rec = 0
        if self.family == "griffin":
            W = self.lru_width or D
            rec = 2 * D * W + W * D + self.conv_width * W + 3 * W
        if self.family == "rwkv6":
            rec = 6 * D * D
        per_layer = {"global": attn + mlp, "local": attn + mlp,
                     "rec": rec + mlp, "rwkv": rec + mlp}
        total = 0
        for i in range(self.n_layers):
            total += per_layer[self.pattern[i % len(self.pattern)]]
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + mlp) + self.n_layers * attn
        total += V * D * (1 if self.tie_embeddings else 2)
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.n_params()
        D, F = self.d_model, self.d_ff
        dense_mlp = D * F * (3 if self.mlp_gated else 2)
        return (self.n_params()
                - self.n_layers * dense_mlp * (self.n_experts - self.topk))


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


_REGISTRY: dict[str, tuple] = {}


def register(arch_id: str, config: ModelConfig, smoke: ModelConfig):
    _REGISTRY[arch_id] = (config, smoke)


def registry() -> dict:
    _ensure_loaded()
    return dict(_REGISTRY)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    cfg, sm = _REGISTRY[arch_id]
    return sm if smoke else cfg


_ARCHS = [
    "recurrentgemma_9b", "whisper_large_v3", "gemma2_2b", "granite_8b",
    "qwen3_1_7b", "gemma2_27b", "chameleon_34b", "dbrx_132b",
    "granite_moe_1b", "rwkv6_7b",
]


def _ensure_loaded():
    if _REGISTRY:
        return
    import importlib
    for a in _ARCHS:
        importlib.import_module(f"repro_torch.configs.{a}")
