"""gemma2-2b [dense]: local/global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab=256_000, head_dim=256, pattern=("local", "global"),
    window=4096, softcap_attn=50.0, softcap_final=30.0,
    mlp_act="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, pattern=("local", "global"),
    window=32, softcap_attn=50.0, softcap_final=30.0,
    mlp_act="gelu", tie_embeddings=True,
)

register("gemma2-2b", CONFIG, SMOKE)
