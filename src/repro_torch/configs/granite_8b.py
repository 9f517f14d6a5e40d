"""granite-8b [dense]: llama-architecture code model [arXiv:2405.04324; hf]."""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=49_152, pattern=("global",), mlp_act="silu",
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, pattern=("global",), mlp_act="silu",
)

register("granite-8b", CONFIG, SMOKE)
