"""whisper-large-v3 [audio]: encoder-decoder backbone; conv frontend is a
STUB — input_specs() provides precomputed frame embeddings
[arXiv:2212.04356; unverified]."""
from .base import ModelConfig, register

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51_866, pattern=("global",), mlp_act="gelu", mlp_gated=False,
    n_enc_layers=32, enc_seq=1500, tie_embeddings=True,
    # 20 heads cannot shard a 16-way model axis: without T-sharding the
    # attention replicates per rank (§Perf cell b's diagnosis) — ship the
    # proven fix as this arch's default
    seq_parallel=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, pattern=("global",), mlp_act="gelu", mlp_gated=False,
    n_enc_layers=2, enc_seq=64, tie_embeddings=True,
)

register("whisper-large-v3", CONFIG, SMOKE)
