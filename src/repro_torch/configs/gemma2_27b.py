"""gemma2-27b [dense]: local/global alternating, logit softcaps
[arXiv:2408.00118; hf]."""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab=256_000, head_dim=128, pattern=("local", "global"),
    window=4096, softcap_attn=50.0, softcap_final=30.0,
    mlp_act="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-27b-smoke", family="dense",
    n_layers=4, d_model=96, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab=512, head_dim=24, pattern=("local", "global"),
    window=32, softcap_attn=50.0, softcap_final=30.0,
    mlp_act="gelu", tie_embeddings=True,
)

register("gemma2-27b", CONFIG, SMOKE)
