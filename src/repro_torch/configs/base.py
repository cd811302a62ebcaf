"""Model configuration and the arch registry (port of ``repro/configs/base.py``).

A copy rather than an import: the reference module imports ``core.qlinear``, which
pulls in jax. Every registered arch is listed so ``get`` resolves the same names.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from repro_torch.core.qlinear import FP, QuantConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    act: str = "silu_glu"             # silu_glu | gelu_glu | gelu | relu2
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    use_rope: bool = True
    rope_theta: float = 10000.0
    causal: bool = True
    window: Optional[int] = None      # sliding window for local layers
    layer_pattern: str = "global"     # global | local_global (gemma2 alternation)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    embed_scale: bool = False         # gemma: x *= sqrt(d_model)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # hybrid (zamba2): one shared attention+MLP block applied every `attn_every` layers
    attn_every: int = 0

    # modality frontend stubs
    frontend: str = "none"            # none | vision_stub | audio_stub
    frontend_dim: int = 0
    n_patches: int = 0

    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    quant: QuantConfig = FP

    @property
    def vocab_padded(self) -> int:
        """Embedding/lm-head rows padded to a multiple of 256; padded ids are
        masked to -1e9 in the lm head."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def subquadratic(self) -> bool:
        """No full-attention layer whose cost is O(S^2) over a long context at
        prefill, and decode state O(1) or O(T) linear."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers) of a dense decoder, or of
        an SSM / hybrid stack (in_proj, conv, out_proj, A/D/dt_bias per layer, plus
        the hybrid's one shared attention + MLP block)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm", "hybrid"):
            di, N, G = self.d_inner, self.ssm_state, self.ssm_groups
            per_layer = (d * (2 * di + 2 * G * N + self.ssm_heads)
                         + (di + 2 * G * N) * self.ssm_conv + di * d + 3 * self.ssm_heads)
            n += per_layer * L
            if self.family == "hybrid" and self.attn_every:
                hd, kv = self.n_heads * self.head_dim, self.n_kv_heads * self.head_dim
                n += d * (hd + 2 * kv) + hd * d + 2 * d * self.d_ff
            return n
        hd = self.n_heads * self.head_dim
        kv = self.n_kv_heads * self.head_dim
        gate_mult = 3 if self.act.endswith("_glu") else 2
        return n + L * (d * (hd + 2 * kv) + hd * d + gate_mult * d * self.d_ff)


ARCH_MODULES = [
    "mamba2_130m", "llama4_scout_17b_a16e", "granite_moe_3b_a800m", "nemotron_4_15b",
    "deepseek_coder_33b", "gemma2_9b", "starcoder2_7b", "zamba2_1_2b", "pixtral_12b",
    "hubert_xlarge",
]

_REGISTRY: Dict[str, ModelConfig] = {}
_SMOKE: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> None:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke


def _load_all() -> None:
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str, smoke: bool = False) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    reg = _SMOKE if smoke else _REGISTRY
    key = name.replace("-", "_")
    for k, v in reg.items():
        if k.replace("-", "_") == key:
            return v
    raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")


def all_archs() -> Tuple[str, ...]:
    if not _REGISTRY:
        _load_all()
    return tuple(sorted(_REGISTRY))
