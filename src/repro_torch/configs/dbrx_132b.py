"""dbrx-132b [moe]: 16 experts top-4 fine-grained MoE
[hf:databricks/dbrx-base; unverified]."""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100_352, pattern=("global",), mlp_act="silu",
    n_experts=16, topk=4, rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="dbrx-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=512, pattern=("global",), mlp_act="silu",
    n_experts=4, topk=2,
)

register("dbrx-132b", CONFIG, SMOKE)
