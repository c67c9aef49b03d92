"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400; llama-arch (SwiGLU, RMSNorm, RoPE 1e4).
[arXiv:2401.02954; hf]"""
from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="deepseek-67b", family="decoder",
        n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=22016, vocab=102400, mlp_type="swiglu", rope_theta=10000.0,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-67b-smoke", family="decoder",
        n_layers=5, d_model=256, n_heads=8, n_kv_heads=2, d_head=32,
        d_ff=688, vocab=512, mlp_type="swiglu", rope_theta=10000.0,
        remat="none",
    )
