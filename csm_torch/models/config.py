"""Model configuration for the PyTorch/CUDA CSM port.

A copy of the JAX package's ``models/config.py`` (pure dataclasses): the
port imports nothing from that package, so the two stay in step by hand.

The reference hardcodes its model hyperparameters at construction sites
(reference: src/csm/models/model.py:11-42, src/csm/generator.py:232-238);
here they are promoted to a real config system (SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Llama-3.2-style decoder-only transformer hyperparameters.

    Matches the torchtune ``llama3_2`` factory arguments used by the
    reference (src/csm/models/model.py:11-42): GQA attention, SwiGLU MLP,
    RMSNorm, Llama-3.1-style frequency-scaled RoPE.
    """

    num_layers: int
    num_heads: int
    num_kv_heads: int
    embed_dim: int
    intermediate_dim: int
    max_seq_len: int = 2048
    norm_eps: float = 1e-5
    rope_base: float = 500_000.0
    # Llama-3.x rope frequency scaling (torchtune Llama3ScaledRoPE semantics).
    rope_scale_factor: float = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_old_context_len: int = 8192
    attn_dropout: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


def llama3_2_1B() -> TransformerConfig:
    """Backbone flavor (reference: src/csm/models/model.py:11-25)."""
    return TransformerConfig(
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        embed_dim=2048,
        intermediate_dim=8192,
        max_seq_len=2048,
    )


def llama3_2_100M() -> TransformerConfig:
    """Audio-decoder flavor (reference: src/csm/models/model.py:28-42)."""
    return TransformerConfig(
        num_layers=4,
        num_heads=8,
        num_kv_heads=2,
        embed_dim=1024,
        intermediate_dim=8192,
        max_seq_len=2048,
    )


def llama3_2_300M() -> TransformerConfig:
    """300M-class audio decoder for the 8B flavor
    (docs/reference/sesame_csm/components.md:90: the Medium model's
    decoder is ~300M parameters; its exact shape was never published, so
    this keeps the released 100M decoder's width/head layout and deepens
    it to 12 layers ≈ 330M params)."""
    return TransformerConfig(
        num_layers=12,
        num_heads=8,
        num_kv_heads=2,
        embed_dim=1024,
        intermediate_dim=8192,
        max_seq_len=2048,
    )


def llama3_1_8B() -> TransformerConfig:
    """8B backbone flavor — the original Sesame CSM's internal scale
    (docs/reference/sesame_csm/components.md:8-10: 8B backbone + 300M
    decoder; weights were never released).  Provided as the
    tensor-parallel scaling target."""
    return TransformerConfig(
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        embed_dim=4096,
        intermediate_dim=14336,
        max_seq_len=2048,
    )


FLAVORS = {
    "llama-1B": llama3_2_1B,
    "llama-100M": llama3_2_100M,
    "llama-300M": llama3_2_300M,
    "llama-8B": llama3_1_8B,
}


@dataclasses.dataclass(frozen=True)
class ModelArgs:
    """CSM model arguments (reference: src/csm/models/model.py:99-107).

    Accepts either flavor names (``llama-1B``/``llama-100M``) or explicit
    TransformerConfig overrides (for tiny test models).
    """

    backbone_flavor: str = "llama-1B"
    decoder_flavor: str = "llama-100M"
    text_vocab_size: int = 128_256
    audio_vocab_size: int = 2051
    audio_num_codebooks: int = 32
    backbone_config: Optional[TransformerConfig] = None
    decoder_config: Optional[TransformerConfig] = None

    @property
    def backbone(self) -> TransformerConfig:
        if self.backbone_config is not None:
            return self.backbone_config
        return FLAVORS[self.backbone_flavor]()

    @property
    def decoder(self) -> TransformerConfig:
        if self.decoder_config is not None:
            return self.decoder_config
        return FLAVORS[self.decoder_flavor]()

    @property
    def num_total_columns(self) -> int:
        """Width of one token frame: 32 audio codebooks + 1 text column
        (reference: src/csm/generator.py:92-96)."""
        return self.audio_num_codebooks + 1

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "ModelArgs":
        d = json.loads(s)
        for key in ("backbone_config", "decoder_config"):
            if d.get(key) is not None:
                d[key] = TransformerConfig(**d[key])
        return ModelArgs(**d)


def csm_1b_args(max_seq_len: int = 2048) -> ModelArgs:
    """The CSM-1B production configuration
    (reference: src/csm/generator.py:232-238).

    ``max_seq_len`` — context length; 2048 matches the reference.  Larger
    values (4096, 8192) extend the RoPE table and KV caches for
    long-context inference/training (beyond-reference capability)."""
    kw = {}
    if max_seq_len != 2048:
        kw = dict(
            backbone_config=dataclasses.replace(
                llama3_2_1B(), max_seq_len=max_seq_len
            ),
            decoder_config=dataclasses.replace(
                llama3_2_100M(), max_seq_len=max_seq_len
            ),
        )
    return ModelArgs(
        backbone_flavor="llama-1B",
        decoder_flavor="llama-100M",
        text_vocab_size=128_256,
        audio_vocab_size=2051,
        audio_num_codebooks=32,
        **kw,
    )


def csm_8b_args() -> ModelArgs:
    """The original Sesame CSM's internal scale: 8B backbone + 300M-class
    decoder (docs/reference/sesame_csm/components.md:8-10,90)."""
    return ModelArgs(
        backbone_flavor="llama-8B",
        decoder_flavor="llama-300M",
        text_vocab_size=128_256,
        audio_vocab_size=2051,
        audio_num_codebooks=32,
    )


def with_horizon(args: ModelArgs, horizon: int) -> ModelArgs:
    """Same model, longer position horizon: extends the backbone's RoPE
    table / max_seq_len WITHOUT touching any weight shape (positions are
    the only thing ``max_seq_len`` feeds at inference).  Used by
    sliding-window serving, where the KV cache is ``window`` columns but
    absolute positions run past it between re-anchors."""
    if args.backbone.max_seq_len >= horizon:
        return args
    return dataclasses.replace(
        args,
        backbone_config=dataclasses.replace(args.backbone, max_seq_len=horizon),
        decoder_config=args.decoder,
    )


def transformer_param_count(cfg: TransformerConfig) -> int:
    """Exact parameter count of one transformer stack
    (models/llama layout)."""
    E, I, D = cfg.embed_dim, cfg.intermediate_dim, cfg.head_dim
    qd, kvd = cfg.num_heads * D, cfg.num_kv_heads * D
    per_layer = E * qd + 2 * E * kvd + qd * E + 2 * E * I + I * E + 2 * E
    return cfg.num_layers * per_layer + E


def csm_param_count(args: ModelArgs) -> int:
    """Exact parameter count of the full CSM tree
    (models/csm layout) — the routing signal for the streaming 8B load
    path (bf16 bytes = 2 × this)."""
    bb, dec = args.backbone, args.decoder
    K, V = args.audio_num_codebooks, args.audio_vocab_size
    return (
        transformer_param_count(bb)
        + transformer_param_count(dec)
        + args.text_vocab_size * bb.embed_dim
        + V * K * bb.embed_dim
        + bb.embed_dim * dec.embed_dim
        + bb.embed_dim * V
        + (K - 1) * dec.embed_dim * V
    )


def tiny_test_args(
    audio_num_codebooks: int = 4,
    text_vocab_size: int = 128,
    audio_vocab_size: int = 64,
) -> ModelArgs:
    """A tiny CSM for unit tests (analogue of the reference's tiny-model
    fixture factory, tests/create_test_model.py:42-301)."""
    return ModelArgs(
        backbone_flavor="tiny",
        decoder_flavor="tiny",
        text_vocab_size=text_vocab_size,
        audio_vocab_size=audio_vocab_size,
        audio_num_codebooks=audio_num_codebooks,
        backbone_config=TransformerConfig(
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            embed_dim=64,
            intermediate_dim=128,
            max_seq_len=128,
        ),
        decoder_config=TransformerConfig(
            num_layers=2,
            num_heads=2,
            num_kv_heads=1,
            embed_dim=32,
            intermediate_dim=64,
            max_seq_len=128,
        ),
    )


def tiny_file_args() -> ModelArgs:
    """Tiny layer sizes with the FULL 1B token geometry (K=32, audio
    vocab 2051, text vocab 128256): checkpoints exported with these args
    carry the exact key set and token-space shapes of the real ``ckpt.pt``
    (reference src/csm/generator.py:221-244) at unit-test cost — the
    file-level checkpoint-format fixture (csm-generate --flavor tiny;
    tests/test_file_checkpoint_e2e.py)."""
    return tiny_test_args(
        audio_num_codebooks=32,
        text_vocab_size=128_256,
        audio_vocab_size=2051,
    )
