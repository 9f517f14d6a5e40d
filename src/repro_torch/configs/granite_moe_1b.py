"""granite-moe-1b-a400m [moe]: 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49_155, pattern=("global",), mlp_act="silu",
    n_experts=32, topk=8, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=512, pattern=("global",), mlp_act="silu",
    n_experts=8, topk=2, tie_embeddings=True,
)

register("granite-moe-1b-a400m", CONFIG, SMOKE)
