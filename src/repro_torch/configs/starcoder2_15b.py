"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152; GELU MLP with biases, LayerNorm, RoPE (base 1e5).
[arXiv:2402.19173; hf]"""
from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="starcoder2-15b", family="decoder",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_head=128,
        d_ff=24576, vocab=49152, mlp_type="gelu", use_bias=True,
        norm_type="layernorm", rope_theta=100000.0,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="starcoder2-15b-smoke", family="decoder",
        n_layers=4, d_model=192, n_heads=6, n_kv_heads=2, d_head=32,
        d_ff=768, vocab=512, mlp_type="gelu", use_bias=True,
        norm_type="layernorm", rope_theta=100000.0,
        remat="none",
    )
