"""Model, shape, parallelism, training and job configuration for the
PyTorch port: copies of ``ModelConfig`` (and its ``reduced()``),
``ShapeConfig``, ``ParallelConfig``, ``TrainConfig`` and ``RunConfig`` from
the JAX package's ``configs/base.py``, kept verbatim so both packages
describe a model, its mesh and its optimizer with the same numbers.  The port imports
nothing of the JAX package, so it carries its own copy.

One ``ModelConfig`` dataclass covers every architecture family
(dense / moe / hybrid / ssm / encdec / vlm); the port runs every
family, with the configs registered in ``repro_torch.configs``.
Configs are frozen; derived
quantities are properties.  ``reduced()`` produces a small same-family config
for CPU tests.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    # --- identity -----------------------------------------------------------
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    source: str = ""  # provenance tag from the assignment table

    # --- transformer backbone ------------------------------------------------
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12          # 0 => attention-free family
    num_kv_heads: int = 12
    head_dim: int = 0            # 0 => d_model // num_heads
    d_ff: int = 3072
    vocab_size: int = 32000
    act: str = "silu"            # silu (SwiGLU) | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    qk_norm: bool = False        # qwen3
    tie_embeddings: bool = False
    use_bias: bool = False

    # --- MoE ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0            # expert hidden dim (d_ff used for the dense path)
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    moe_every: int = 1           # MoE in every k-th layer (1 = all layers)

    # --- SSM / hybrid ----------------------------------------------------------
    ssm_state: int = 0           # mamba2 d_state
    ssm_head_dim: int = 64       # mamba2 P (channels per head)
    ssm_expand: int = 2          # d_inner = expand * d_model
    ssm_conv_dim: int = 4        # depthwise conv width
    ssm_chunk: int = 256         # SSD chunk length
    hybrid_attn_every: int = 0   # zamba2: shared attention block cadence (0 = none)

    # --- RWKV -------------------------------------------------------------------
    rwkv_head_dim: int = 64

    # --- encoder-decoder ---------------------------------------------------------
    encoder_layers: int = 0
    enc_ratio: int = 4           # enc_len = seq_len // enc_ratio (stub frontend frames)

    # --- VLM -----------------------------------------------------------------------
    num_image_tokens: int = 0    # stub ViT patch embeddings prepended to the text

    # --- numerics --------------------------------------------------------------------
    dtype: str = "bfloat16"      # activation/compute dtype
    param_dtype: str = "float32"  # master weights

    # ------------------------------------------------------------------ derived ---
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (Megatron convention, MXU friendly)."""
        return pad_to_multiple(self.vocab_size, 128)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / linear attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        """Encoder-only archs have no decode step; all assigned archs decode."""
        return True

    # --------------------------------------------------------------- counting ----
    def param_count(self) -> int:
        """Analytic parameter count (matches the initializer tree; tested)."""
        d, v = self.d_model, self.padded_vocab
        hd = self.resolved_head_dim
        n = v * d                      # token embedding
        if not self.tie_embeddings:
            n += v * d                 # lm head
        n += d                         # final norm

        def attn_params() -> int:
            p = d * self.num_heads * hd          # q
            p += 2 * d * self.num_kv_heads * hd  # k, v
            p += self.num_heads * hd * d         # o
            if self.qk_norm:
                p += 2 * hd
            return p

        def dense_ffn(dff: int) -> int:
            if self.act == "silu":
                return 3 * d * dff   # gate, up, down
            return 2 * d * dff

        def moe_ffn() -> int:
            p = d * self.num_experts                      # router
            p += self.num_experts * 3 * d * self.moe_d_ff  # experts (SwiGLU)
            if self.dense_residual:
                p += dense_ffn(self.d_ff)
            return p

        def mamba_params() -> int:
            din, s, hn = self.d_inner, self.ssm_state, self.ssm_heads
            p = d * (2 * din + 2 * s + hn)  # in_proj -> [x, z, B, C, dt]
            p += self.ssm_conv_dim * (din + 2 * s)  # depthwise conv over x,B,C
            p += hn + hn                    # A_log, D
            p += hn                         # dt_bias
            p += din                        # gated norm scale
            p += din * d                    # out_proj
            return p

        def rwkv_params() -> int:
            p = 0
            p += 6 * d          # token-shift mix coefficients (r,k,v,w,g + lerp x)
            p += d * 64 + 64 * d * 5   # low-rank data-dependent mix (lora dim 64)
            p += d * d * 4      # r,k,v,g projections
            p += d * 64 + 64 * d  # decay lora
            p += self.rwkv_heads * self.rwkv_head_dim  # u (bonus)
            p += d              # ln_x scale
            p += d * d          # output proj
            p += dense_ffn_rwkv()
            return p

        def dense_ffn_rwkv() -> int:
            return 2 * d + d * self.d_ff + self.d_ff * d  # rwkv channel-mix

        per_layer_norms = 2 * d

        total_layers = 0
        if self.family in ("dense", "vlm"):
            n += self.num_layers * (attn_params() + dense_ffn(self.d_ff) + per_layer_norms)
        elif self.family == "moe":
            n += self.num_layers * (attn_params() + moe_ffn() + per_layer_norms)
        elif self.family == "ssm":
            n += self.num_layers * (rwkv_params() + per_layer_norms)
        elif self.family == "hybrid":
            n += self.num_layers * (mamba_params() + d)  # one pre-norm per mamba layer
            if self.hybrid_attn_every:
                # one shared attention+ffn block (weights tied across invocations)
                n += attn_params() + dense_ffn(self.d_ff) + per_layer_norms
                n += 2 * d * d  # concat(current, embed) down-projection (zamba style)
        elif self.family == "encdec":
            enc_attn = attn_params()
            n += self.encoder_layers * (enc_attn + dense_ffn(self.d_ff) + per_layer_norms)
            # decoder: self attn + cross attn + ffn
            n += self.num_layers * (2 * attn_params() + dense_ffn(self.d_ff) + 3 * d)
            n += d  # encoder final norm
        else:
            raise ValueError(self.family)
        del total_layers
        if self.family == "vlm" and self.num_image_tokens:
            n += self.num_image_tokens * d  # learned image-token position table (stub)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        inactive_experts = self.num_experts - self.experts_per_token
        per_layer_inactive = inactive_experts * 3 * self.d_model * self.moe_d_ff
        n_moe_layers = len([i for i in range(self.num_layers) if i % self.moe_every == 0])
        return full - n_moe_layers * per_layer_inactive

    def flops_per_token(self, seq_len: int, kind: str = "train") -> float:
        """Model FLOPs per token: 6·N_active (train) / 2·N_active (fwd/decode)
        plus attention score·value FLOPs.

        Causal full-sequence attention averages S/2 keys per query:
        fwd = 2 matmuls × 2 flops × H·hd·S/2 = 2·H·hd·S per layer per token
        (×3 with backward).  Decode attends to the whole cache: 4·H·hd·S.
        """
        n_active = self.active_param_count()
        mult = 6.0 if kind == "train" else 2.0
        flops = mult * n_active
        if self.num_heads and self.family != "ssm":
            hd = self.resolved_head_dim
            n_attn_layers = self.num_layers
            if self.family == "hybrid" and self.hybrid_attn_every:
                n_attn_layers = self.num_layers // self.hybrid_attn_every
            if self.family == "encdec":
                n_attn_layers = self.num_layers + self.encoder_layers
            per_layer = (4.0 if kind == "decode" else 2.0) * \
                self.num_heads * hd * seq_len
            flops += (mult / 2.0 if kind != "decode" else 1.0) * \
                n_attn_layers * per_layer
        return flops

    # --------------------------------------------------------------- reduction ----
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2 if self.family != "hybrid" else 4),
            d_model=128,
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32 if self.num_heads else 0,
            d_ff=256,
            vocab_size=512,
        )
        if self.is_moe:
            changes.update(num_experts=8,
                           experts_per_token=min(self.experts_per_token, 2),
                           moe_d_ff=64)
        if self.family in ("ssm", "hybrid"):
            changes.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
        if self.hybrid_attn_every:
            changes.update(hybrid_attn_every=2)
        if self.family == "encdec":
            changes.update(encoder_layers=2)
        if self.family == "vlm":
            changes.update(num_image_tokens=8)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    """An input-shape cell. kind selects which step gets lowered."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


@dataclass(frozen=True)
class ParallelConfig:
    """How a job maps onto the mesh."""
    mesh_shape: Tuple[int, ...] = (16, 16)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    fsdp: bool = True               # shard params/opt over "data" (ZeRO-3)
    zero_stage: int = 3             # 0: replicated grads+state; 2: sharded state; 3: sharded params
    pipeline_stages: int = 1        # >1 => pipeline over leading axis
    remat: str = "selective"        # none | selective | full
    scan_layers: bool = True
    microbatches: int = 1
    grad_compression: str = "none"  # none | int8_ef
    collective_matmul: bool = False

    @property
    def num_devices(self) -> int:
        return math.prod(self.mesh_shape)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    z_loss: float = 1e-4            # logit z-loss (stability at scale)
    moe_aux_loss: float = 1e-2      # load-balance loss weight


@dataclass(frozen=True)
class RunConfig:
    """A full job description (what the scheduler queues)."""
    model: ModelConfig = None
    shape: ShapeConfig = None
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    checkpoint_dir: str = "/tmp/repro_ckpt"
    checkpoint_every: Optional[int] = None  # None => Young's formula
