"""Architecture configs + input shapes + registry (the port's copy of
`repro.configs.base`).

Every architecture is a frozen `ArchConfig`.  TP-divisibility padding is
kept exactly as in the JAX package (`n_heads_padded`, `n_kv_heads_eff`,
`vocab_padded`): parameters carried across from the JAX package only line
up when both pad the same way.  `input_specs` gives a step's abstract
inputs as "meta" tensors (the JAX function's ``ShapeDtypeStruct``s): the
same keys, shapes and dtypes, no allocation.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

__all__ = ["TP_DEGREE", "MoeParams", "SsmParams", "ArchConfig", "ShapeSpec",
           "SHAPES", "SHAPE_BY_NAME", "ARCH_IDS", "ALIASES", "get_config",
           "reduced_config", "input_specs"]

TP_DEGREE = 16  # the production mesh's "model" axis


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoeParams:
    n_experts: int
    top_k: int
    d_ff_expert: int
    d_ff_shared: int = 0
    shared_gated: bool = False
    capacity_factor: float = 1.25
    group_size: int = 0         # GShard routing groups

    @property
    def n_experts_padded(self) -> int:
        return _pad_to(self.n_experts, TP_DEGREE)


@dataclasses.dataclass(frozen=True)
class SsmParams:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int                # true query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int                   # dense MLP width (0 = no dense MLP)
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    moe: Optional[MoeParams] = None
    ssm: Optional[SsmParams] = None
    # hybrid (zamba-style): one shared attention+MLP block applied every
    # `hybrid_every` ssm layers, alternating between `n_shared_blocks`
    # parameter sets
    hybrid_every: int = 0
    n_shared_blocks: int = 2
    # modality stub: inputs are precomputed embeddings of this width
    d_input_stub: int = 0
    stub_seq: int = 0           # e.g. image patches prepended (vlm)
    causal: bool = True
    source: str = ""            # provenance note
    force_kv_replicate: bool = False

    # -- TP padding policy -----------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256; logits beyond `vocab` are
        masked in the serve paths (`lm.mask_vocab_pad`)."""
        return _pad_to(self.vocab, 256)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def n_heads_padded(self) -> int:
        return _pad_to(self.n_heads, TP_DEGREE) if self.n_heads else 0

    @property
    def n_kv_heads_eff(self) -> int:
        """KV heads actually materialized: padded to TP if shardable,
        else kept."""
        if not self.n_heads:
            return 0
        if self.n_kv_heads >= TP_DEGREE and not self.force_kv_replicate:
            return _pad_to(self.n_kv_heads, TP_DEGREE)
        return self.n_kv_heads

    @property
    def kv_sharded(self) -> bool:
        """Whether the KV heads shard over the model axis (at least
        `TP_DEGREE` of them, not forced to replicate)."""
        return bool(self.n_heads) and self.n_kv_heads >= TP_DEGREE \
            and not self.force_kv_replicate

    @property
    def sharding_overrides(self) -> Dict[str, Optional[str]]:
        """Arch-dependent logical-axis mapping tweaks: with KV heads too
        few to shard, the KV projections replicate and the KV cache shards
        along its sequence instead."""
        out: Dict[str, Optional[str]] = {}
        if self.n_heads and not self.kv_sharded:
            out["kv_qkv"] = None        # replicate kv projections
            out["kv_heads"] = None
            out["cache_seq"] = "model"  # shard the KV cache along sequence
        return out

    @property
    def supports_decode(self) -> bool:
        """Whether the family decodes token by token (the encoder does
        not)."""
        return self.family != "encoder"

    @property
    def subquadratic(self) -> bool:
        """May run long_500k (SSM / hybrid); pure full-attention archs skip."""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}

ARCH_IDS = (
    "zamba2_2p7b", "qwen2p5_14b", "yi_6b", "qwen1p5_4b", "qwen1p5_0p5b",
    "qwen2_moe_a2p7b", "llama4_scout_17b_a16e", "pixtral_12b",
    "mamba2_2p7b", "hubert_xlarge",
)

# CLI aliases (dashed ids)
ALIASES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2.5-14b": "qwen2p5_14b",
    "yi-6b": "yi_6b",
    "qwen1.5-4b": "qwen1p5_4b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "pixtral-12b": "pixtral_12b",
    "mamba2-2.7b": "mamba2_2p7b",
    "hubert-xlarge": "hubert_xlarge",
}


def get_config(arch: str) -> ArchConfig:
    arch = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def reduced_config(cfg: ArchConfig, n_layers: int = 2, d_model: int = 128,
                   vocab: int = 512) -> ArchConfig:
    """Smoke-test-sized config of the same family."""
    scale = d_model / cfg.d_model
    n_heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    kv = min(cfg.n_kv_heads, n_heads) if cfg.n_heads else 0
    kw = dict(
        name=cfg.name + "-smoke", family=cfg.family, n_layers=n_layers,
        d_model=d_model, n_heads=n_heads, n_kv_heads=kv,
        d_ff=max(64, int(cfg.d_ff * scale)) if cfg.d_ff else 0,
        vocab=vocab, qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta,
        causal=cfg.causal, source="smoke")
    if cfg.moe:
        kw["moe"] = MoeParams(n_experts=8, top_k=min(cfg.moe.top_k, 2),
                              d_ff_expert=64,
                              d_ff_shared=64 if cfg.moe.d_ff_shared else 0,
                              shared_gated=cfg.moe.shared_gated)
    if cfg.ssm:
        kw["ssm"] = SsmParams(d_state=16, head_dim=32, expand=2, chunk=32)
    if cfg.hybrid_every:
        kw["hybrid_every"] = 2
        kw["n_shared_blocks"] = cfg.n_shared_blocks
        kw["n_layers"] = 4
    if cfg.d_input_stub:
        kw["d_input_stub"] = 64
        kw["stub_seq"] = min(cfg.stub_seq, 16) if cfg.stub_seq else 0
    return ArchConfig(**kw)


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                max_decode_len: Optional[int] = None) -> Dict:
    """Every model input of a step as a "meta" tensor (no allocation):
    int32 tokens and targets (the vlm's text rows only, ``S - stub_seq``;
    none for the encoder, whose input is bf16 ``frames``), the vlm's bf16
    ``patch_embeds``, no targets for a prefill; a decode step's one token
    a row and its 0-d int32 ``pos``.  ``max_decode_len`` is taken as the
    JAX function takes it, and changes nothing."""
    B, S = shape.global_batch, shape.seq_len

    def meta(size, dtype):
        return torch.empty(size, dtype=dtype, device="meta")

    def tok(b, s):
        return meta((b, s), torch.int32)

    if shape.kind in ("train", "prefill"):
        spec = {"tokens": tok(B, S), "targets": tok(B, S)}
        if cfg.family == "vlm":
            s_img = cfg.stub_seq
            spec["tokens"] = tok(B, S - s_img)
            spec["targets"] = tok(B, S - s_img)
            spec["patch_embeds"] = meta((B, s_img, cfg.d_input_stub),
                                        torch.bfloat16)
        elif cfg.family == "encoder":
            spec["frames"] = meta((B, S, cfg.d_input_stub), torch.bfloat16)
            del spec["tokens"]
        if shape.kind == "prefill":
            spec.pop("targets", None)
        return spec
    # decode: one new token against a cache of length seq_len
    return {"tokens": tok(B, 1), "pos": meta((), torch.int32)}
