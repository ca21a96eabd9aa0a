"""Phi-3-medium (14B) — RoPE, SwiGLU, GQA kv=10 [arXiv:2404.14219].

The reference's configuration, copied unchanged (vocab 100352 included).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=10000.0,
    sub_quadratic=False,
)
