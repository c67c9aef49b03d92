"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + Mamba heads per block,
sliding window 1024 with full-attention layers every 16 (layers 0 and 16).
[arXiv:2411.13676; hf]"""
from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
        d_ff=5504, vocab=32001, ssm_state=16, d_inner=3200,
        window=1024, global_every=16, rope_theta=10000.0,
        ssm_chunk=512,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="hymba-1.5b-smoke", family="hybrid",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=448, vocab=512, ssm_state=8, d_inner=256,
        window=16, global_every=2, rope_theta=10000.0,
        remat="none",
    )
