"""Model configuration and layer-pattern machinery (twin of
``repro/models/config.py``, copied unchanged but for this docstring).

Every architecture of the zoo is a ``ModelConfig`` plus a *layer pattern*:
the stack splits into a repeated "period" of layers after optional prefix
layers. The reference scans the period over stacked parameters; the port
runs its layers as a Python loop over an ``nn.ModuleList``
(``models/model.py``). The port runs seven of the ten ids so far
(``configs.PORTED_IDS``); the MoE models ``mixtral-8x22b``,
``jamba-v0.1-52b`` and ``kimi-k2-1t-a32b`` wait (ROADMAP §A item 10).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of a period: token mixer + channel mixer."""

    mixer: str = "attn"        # 'attn' | 'mamba' | 'cross_attn'
    mlp: str = "dense"         # 'dense' | 'moe' | 'none' (mamba has no mlp in mamba2)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    head_dim: int = 0                   # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0         # chatglm3: 0.5 ("RoPE 2d": half the dims)
    rmsnorm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                   # 0 -> d_ff
    capacity_factor: float = 1.25
    n_dense_prefix: int = 0             # leading dense layers before MoE stack
    router_aux_coef: float = 0.01

    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # Hybrid (Jamba): one attention layer per `attn_period` layers
    attn_period: int = 0                # 0 -> not hybrid
    attn_offset: int = 4                # index of the attn layer inside a period
    moe_every: int = 0                  # jamba: MoE on every `moe_every`-th layer

    # Attention variants
    sliding_window: Optional[int] = None

    # VLM: cross-attention to image embeddings every k-th layer
    cross_attn_every: int = 0
    n_media_tokens: int = 0             # patches / frames provided by the stub

    # Encoder-decoder (audio)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0                # stub frame count for enc/cross inputs

    # Training
    lr_schedule: str = "constant"       # constant | wsd (minicpm)
    param_dtype: str = "float32"
    # Fully unroll internal lax.scans (layer periods, SSD chunks, encoder).
    # Runtime-neutral on real steps, but REQUIRED for exact compile-time
    # cost_analysis: XLA counts a while-loop body once, not trip-count
    # times. The dry-run sets this for cost-exact lowering.
    scan_unroll: bool = False
    # Gradient-checkpoint each layer inside the period scan: backward
    # recomputes the layer instead of saving its internals (notably the
    # fp32 attention probabilities) — the §Perf memory-term knob.
    remat_layers: bool = False
    # Store attention scores/probabilities in bf16 (max/sum reductions stay
    # fp32). Halves the dominant s^2 HBM traffic of the einsum attention
    # path — §Perf memory-term knob for the 32k prefill shapes.
    attn_probs_bf16: bool = False

    # ----------------------------------------------------------------- utils

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def layer_specs(self) -> List[LayerSpec]:
        """Full per-layer description of the decoder stack."""
        specs: List[LayerSpec] = []
        for i in range(self.n_layers):
            if self.attn_period:
                mixer = "attn" if i % self.attn_period == self.attn_offset else "mamba"
            elif self.arch_type == "ssm":
                mixer = "mamba"
            elif self.cross_attn_every and (i % self.cross_attn_every
                                            == self.cross_attn_every - 1):
                mixer = "cross_attn"
            else:
                mixer = "attn"

            if self.n_experts and i >= self.n_dense_prefix:
                if self.moe_every:
                    mlp = "moe" if i % self.moe_every == 1 else "dense"
                else:
                    mlp = "moe"
            else:
                mlp = "none" if mixer == "mamba" and self.arch_type == "ssm" \
                    else "dense"
            specs.append(LayerSpec(mixer=mixer, mlp=mlp))
        return specs

    def period_decomposition(self) -> Tuple[List[LayerSpec], List[LayerSpec], int]:
        """Split the stack into (prefix_specs, period_specs, n_periods).

        The prefix is unrolled; the period repeats n_periods times under scan.
        """
        specs = self.layer_specs()
        prefix = specs[: self.n_dense_prefix]
        body = specs[self.n_dense_prefix:]
        if not body:
            return prefix, [], 0
        # Find the smallest period that tiles the body.
        for plen in range(1, len(body) + 1):
            if len(body) % plen:
                continue
            if all(body[i] == body[i % plen] for i in range(len(body))):
                return prefix, body[:plen], len(body) // plen
        return prefix, body, 1

    def encoder_period(self) -> Tuple[List[LayerSpec], int]:
        """Encoder stack (bidirectional attention, dense mlp)."""
        if not self.is_encoder_decoder:
            return [], 0
        return [LayerSpec(mixer="attn", mlp="dense")], self.n_encoder_layers

    # ------------------------------------------------------------- counting

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + stack + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                  # lm head
        def attn_params():
            return d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        def dense_mlp():
            return 3 * d * self.d_ff
        def moe_mlp():
            return self.n_experts * 3 * d * self.resolved_moe_ff + d * self.n_experts
        def mamba_params():
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_headdim
            proj_in = d * (2 * d_in + 2 * self.ssm_state + nh)
            conv = self.ssm_conv * (d_in + 2 * self.ssm_state)
            return proj_in + conv + d_in * d + 2 * nh + d_in
        for spec in self.layer_specs():
            total += 2 * d                                # norms
            if spec.mixer in ("attn", "cross_attn"):
                total += attn_params()
            else:
                total += mamba_params()
            if spec.mlp == "dense":
                total += dense_mlp()
            elif spec.mlp == "moe":
                total += moe_mlp()
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                total += 2 * d + attn_params() + dense_mlp()
            # decoder cross-attn blocks (one per decoder layer)
            total += self.n_layers * (d + attn_params())
        total += d                                        # final norm
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        total = self.param_count()
        moe_layers = sum(1 for s in self.layer_specs() if s.mlp == "moe")
        full_moe = moe_layers * self.n_experts * 3 * self.d_model * self.resolved_moe_ff
        act_moe = moe_layers * self.top_k * 3 * self.d_model * self.resolved_moe_ff
        return total - full_moe + act_moe

    def reduced(self, n_layers: int = 2, d_model: int = 256, n_experts: int = 4,
                vocab: int = 512) -> "ModelConfig":
        """CPU-smoke variant of the same family (small dims, same structure)."""
        d_model = min(d_model, 512)
        n_heads = max(2, min(self.n_heads, 4))
        ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        n_kv = max(1, n_heads // min(ratio, n_heads))
        nl = n_layers
        attn_period = self.attn_period
        if attn_period:
            nl = max(nl, attn_period)  # keep >=1 attn layer in hybrids
        cae = self.cross_attn_every
        if cae:
            cae = 2
            nl = max(nl, cae)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=nl,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=2 * d_model,
            moe_d_ff=d_model if self.n_experts else 0,
            vocab_size=vocab,
            n_experts=min(self.n_experts, n_experts) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_dense_prefix=min(self.n_dense_prefix, 1),
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            cross_attn_every=cae,
            n_media_tokens=min(self.n_media_tokens, 16) if self.n_media_tokens else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
        )
