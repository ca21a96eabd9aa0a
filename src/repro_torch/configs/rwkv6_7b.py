"""RWKV6-7B "Finch" — attention-free, data-dependent decay [arXiv:2404.05892].

The reference's configuration, copied unchanged: 64 heads × head_dim 64;
TimeMix (WKV6 matrix state) + ChannelMix per block.  O(1) state.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                 # head_dim = 64
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    pattern=("rwkv",),
    rwkv_chunk=128,
    mlp_type="swiglu",            # unused (channel-mix is internal)
    norm_type="layernorm",
    norm_eps=1e-5,
    rope_theta=0.0,
    sub_quadratic=True,
)
