"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, (rec,rec,local)
pattern [arXiv:2402.19427; unverified]."""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="griffin",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab=256_000, head_dim=256, pattern=("rec", "rec", "local"),
    window=2048, mlp_act="gelu", mlp_gated=True, tie_embeddings=True,
    conv_width=4, lru_width=4096,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="griffin",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=512, head_dim=16, pattern=("rec", "rec", "local"),
    window=32, mlp_act="gelu", tie_embeddings=True,
    conv_width=4, lru_width=64, scan_layers=True,
)

register("recurrentgemma-9b", CONFIG, SMOKE)
