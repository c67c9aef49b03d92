"""deepseek-moe-16b [moe] — 28L d_model=2048 16H d_ff(expert)=1408
vocab=102400; fine-grained MoE: 2 shared + 64 routed top-6, dense layer 0
(width 10944, per the released model).  [arXiv:2401.06066; hf]"""
from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1408, vocab=102400, mlp_type="swiglu", rope_theta=10000.0,
        n_experts=64, top_k=6, n_shared=2, d_expert=1408,
        first_dense_ff=10944,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-moe-16b-smoke", family="moe",
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=96, vocab=512, mlp_type="swiglu", rope_theta=10000.0,
        n_experts=8, top_k=2, n_shared=1, d_expert=96, first_dense_ff=384,
        moe_group_size=64, moe_dropless_prefill=True,
        remat="none",
    )
