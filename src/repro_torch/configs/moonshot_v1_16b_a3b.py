"""moonshot-v1-16b-a3b [moe] — kimi/moonlight: 48L d_model=2048 16H
d_ff(expert)=1408 vocab=163840; 2 shared + 64 routed top-6, dense layer 0
(width 11264).  [hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1408, vocab=163840, mlp_type="swiglu", rope_theta=50000.0,
        n_experts=64, top_k=6, n_shared=2, d_expert=1408,
        first_dense_ff=11264,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b-smoke", family="moe",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=96, vocab=512, mlp_type="swiglu", rope_theta=50000.0,
        n_experts=8, top_k=2, n_shared=1, d_expert=96, first_dense_ff=384,
        moe_group_size=64, moe_dropless_prefill=True,
        remat="none",
    )
