"""qwen3-1.7b [dense]: GQA with per-head q/k RMSNorm [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151_936, pattern=("global",), qk_norm=True, mlp_act="silu",
    tie_embeddings=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, pattern=("global",), qk_norm=True, mlp_act="silu",
    tie_embeddings=True,
)

register("qwen3-1.7b", CONFIG, SMOKE)
