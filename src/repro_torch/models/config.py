"""Architecture configuration: the port's own copy of the reference's
``ModelConfig`` (``repro/models/config.py``), field for field, so that a
config built here and one built there compare equal as dicts.

A model is a stack of blocks; each block is ``(mixer, ffn)`` where
mixer ∈ {attn, mamba} and ffn ∈ {dense, moe, moe+dense, none}.  The port runs
the text pathway of the dense, MoE, SSM and hybrid families; the VLM and
audio families' fields are kept so that every reference config can be
stated here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 → d_model // num_heads
    activation: str = "silu_glu"       # silu_glu | gelu_glu | relu2
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                  # per-expert hidden dim (0 → d_ff)
    dense_residual_d_ff: int = 0       # arctic: dense FFN in parallel with MoE
    moe_layer_period: int = 1          # every k-th block's ffn is MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dropless: bool = False         # exact routing (no capacity drops);
                                       # required for prefill/decode ≡ forward

    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    attn_layer_period: int = 0         # jamba: 1 attn block per k blocks (0 → per pattern)
    attn_layer_offset: int = 4

    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    num_frames: int = 1500             # stub frontend output length

    # VLM
    num_patch_tokens: int = 0
    vision_embed_dim: int = 1024       # stub encoder output dim (pre-projector)

    # serving / attention variants
    sliding_window: int = 0            # 0 = full causal attention
    attention_impl: str = "dense"      # dense | chunked; both run the flash kernel here

    # numerics / memory policy (fsdp: a reference sharding knob, unused here;
    # remat: stack_apply_train checkpoints each superblock)
    dtype: str = "bfloat16"
    fsdp: bool = True
    remat: bool = True
    remat_policy: str = "full"         # full | dots (save matmul outputs)
    scan_layers: bool = True           # reference params stack layers on a leading
                                       # axis; the port keeps a per-layer list

    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def layer_kinds(self) -> List[Tuple[str, str]]:
        """(mixer, ffn) per block, resolving the hybrid/MoE pattern."""
        out: List[Tuple[str, str]] = []
        for i in range(self.num_layers):
            if self.arch_type == "ssm":
                mixer = "mamba"
            elif self.arch_type == "hybrid":
                period = self.attn_layer_period or 8
                mixer = "attn" if (i % period) == (self.attn_layer_offset % period) else "mamba"
            else:
                mixer = "attn"
            if self.num_experts > 0 and (i % self.moe_layer_period) == (self.moe_layer_period - 1):
                ffn = "moe+dense" if self.dense_residual_d_ff else "moe"
            elif self.arch_type == "ssm":
                ffn = "none"            # mamba2 blocks carry no separate FFN
            else:
                ffn = "dense"
            out.append((mixer, ffn))
        return out

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: ≤2 layers, d_model ≤ 512, ≤4 experts, same family."""
        small = dict(
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.resolved_head_dim >= 64 else self.resolved_head_dim,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            dense_residual_d_ff=min(self.dense_residual_d_ff, 256) if self.dense_residual_d_ff else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            encoder_layers=min(self.encoder_layers, 2),
            num_frames=min(self.num_frames, 64),
            num_patch_tokens=min(self.num_patch_tokens, 16),
            vision_embed_dim=min(self.vision_embed_dim, 64),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            attn_layer_offset=1 if self.arch_type == "hybrid" else self.attn_layer_offset,
            attn_layer_period=2 if self.arch_type == "hybrid" else self.attn_layer_period,
            moe_layer_period=min(self.moe_layer_period, 2),
            # Smoke tier asserts cached-decode ≡ dense-forward; capacity
            # dropping is call-size dependent (a decode step never competes
            # for capacity, a full forward may), so parity needs exact routing.
            moe_dropless=True,
            fsdp=False, remat=False, scan_layers=False,
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
