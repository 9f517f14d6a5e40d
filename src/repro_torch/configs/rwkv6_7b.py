"""rwkv6-7b [ssm]: Finch — attention-free, data-dependent per-channel decay
[arXiv:2404.05892; hf]."""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv6",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab=65_536, head_dim=64, pattern=("rwkv",), mlp_act="relu_sq",
    mlp_gated=False,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="rwkv6",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, head_dim=16, pattern=("rwkv",), mlp_act="relu_sq",
    mlp_gated=False,
)

register("rwkv6-7b", CONFIG, SMOKE)
