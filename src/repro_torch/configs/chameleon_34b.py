"""chameleon-34b [vlm]: early-fusion token LM; VQ image-token frontend is a
STUB — input_specs() provides fused token ids [arXiv:2405.09818;
unverified]."""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65_536, pattern=("global",), qk_norm=True, mlp_act="silu",
)

SMOKE = ModelConfig(
    name="chameleon-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    vocab=512, pattern=("global",), qk_norm=True, mlp_act="silu",
)

register("chameleon-34b", CONFIG, SMOKE)
