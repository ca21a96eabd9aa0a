"""Config system: model configs, layer plans, input shape specs.

A copy of :mod:`repro.configs.base` (stdlib only), kept in the port so that
it imports nothing of the reference.  Every architecture is a
:class:`ModelConfig`; the four benchmark shapes (train_4k / prefill_32k /
decode_32k / long_500k) are :class:`ShapeSpec` entries attached to each
config.  ``layer_plan`` turns a config into *segments*, runs of identical
layer structure whose params are stacked on a leading layer axis; the
port's :mod:`repro_torch.models.transformer` walks a segment's layers in a
Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


STANDARD_SHAPES = (
    ShapeSpec("train_4k", "train", 4096, 256),
    ShapeSpec("prefill_32k", "prefill", 32768, 32),
    ShapeSpec("decode_32k", "decode", 32768, 128),
    ShapeSpec("long_500k", "decode", 524288, 1),
)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    block: str                # "attn" | "local" | "rg" | "rwkv"
    mlp: str                  # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerSpec, ...]
    repeats: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    local_window: Optional[int] = None
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    # mlp / moe
    mlp_type: str = "swiglu"  # swiglu | geglu
    moe: Optional[MoESpec] = None
    # block structure
    pattern: Tuple[str, ...] = ("attn",)   # repeating block-type unit
    pattern_tail: Tuple[str, ...] = ()     # non-repeating tail blocks
    # enc-dec (whisper)
    encoder_layers: int = 0
    # recurrent
    d_rnn: Optional[int] = None
    conv_width: int = 4
    rwkv_chunk: int = 32
    # norms / embeddings
    norm_type: str = "rmsnorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embed: bool = False
    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"          # nothing | dots  (hillclimb lever)
    attn_gather_kv: bool = False           # hoist KV gather out of chunk loops
    moe_dispatch: str = "gather"           # gather | local  (hillclimb lever)
    moe_fsdp: bool = True                  # shard expert weights on data axis
    # capability flags (DESIGN.md §6)
    sub_quadratic: bool = False            # can run long_500k
    supports_decode: bool = True
    shapes: Tuple[ShapeSpec, ...] = STANDARD_SHAPES
    notes: str = ""

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def runnable_shapes(self) -> Tuple[ShapeSpec, ...]:
        out = []
        for s in self.shapes:
            if s.name == "long_500k" and not self.sub_quadratic:
                continue          # full-attention archs skip (DESIGN.md §6)
            if s.kind == "decode" and not self.supports_decode:
                continue
            out.append(s)
        return tuple(out)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        per_attn = d * (h + 2 * kv) * hd + h * hd * d
        per_dense_mlp = 3 * d * f
        n = v * d * (1 if self.tie_embeddings else 2)
        for spec in layer_specs(self):
            if spec.block in ("attn", "local"):
                n += per_attn
            elif spec.block == "rg":
                drnn = self.d_rnn or d
                n += 2 * d * drnn + drnn * d + 2 * drnn + self.conv_width * drnn
            elif spec.block == "rwkv":
                # time-mix r,k,v,g,o + channel-mix r (6·d²) + channel-mix
                # k,v (2·d·f) + small lora/decay terms
                n += 6 * d * d + 2 * d * f
            if spec.mlp == "dense":
                n += per_dense_mlp
            elif spec.mlp == "moe":
                m = self.moe
                n += d * m.num_experts  # router
                n += 3 * d * m.d_ff_expert * (m.num_experts + m.num_shared)
        if self.is_enc_dec:  # encoder blocks + cross attention
            n += self.encoder_layers * (per_attn + per_dense_mlp)
            n += self.num_layers * per_attn  # cross-attn in decoder
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        all_experts = 3 * d * m.d_ff_expert * (m.num_experts + m.num_shared)
        active = 3 * d * m.d_ff_expert * (m.top_k + m.num_shared)
        moe_layers = sum(1 for s in layer_specs(self) if s.mlp == "moe")
        return total - moe_layers * (all_experts - active)


def layer_specs(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """Flat per-layer structure (decoder side for enc-dec)."""
    specs = []
    i = 0
    while len(specs) < cfg.num_layers - len(cfg.pattern_tail):
        block = cfg.pattern[i % len(cfg.pattern)]
        specs.append(_spec_for(cfg, block, len(specs)))
        i += 1
    for block in cfg.pattern_tail:
        specs.append(_spec_for(cfg, block, len(specs)))
    return tuple(specs)


def _spec_for(cfg: ModelConfig, block: str, idx: int) -> LayerSpec:
    if block == "rwkv":
        return LayerSpec("rwkv", "none")    # channel-mix lives in the block
    if cfg.moe is not None and idx >= cfg.moe.first_dense_layers:
        return LayerSpec(block, "moe")
    return LayerSpec(block, "dense")


def layer_plan(cfg: ModelConfig) -> Tuple[Segment, ...]:
    """Group layers into scan segments of identical repeating structure."""
    specs = list(layer_specs(cfg))
    unit = len(cfg.pattern)
    segments: list[Segment] = []
    # leading non-uniform part (e.g. deepseek's dense first layer)
    lead = 0
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        lead = cfg.moe.first_dense_layers
        segments.append(Segment(tuple(specs[:lead]), 1))
    body = specs[lead: len(specs) - len(cfg.pattern_tail)]
    if body:
        assert len(body) % unit == 0, (len(body), unit)
        segments.append(Segment(tuple(body[:unit]), len(body) // unit))
    if cfg.pattern_tail:
        segments.append(Segment(tuple(specs[len(specs) - len(cfg.pattern_tail):]), 1))
    return tuple(segments)
