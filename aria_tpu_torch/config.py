"""The port's configuration dataclasses: its own copy of the four that it
uses from aria_tpu/config.py:20-153 (fields, defaults, properties,
``aria_25b()``, ``tiny()``, ``replace()``), so that the port imports
nothing of the JAX package. ``tests/test_torch_kv.py`` holds the two
copies field for field, defaults included.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Tuple


@dataclass(frozen=True)
class VisionConfig:
    """SigLIP-so400m-style ViT."""

    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    patch_size: int = 14
    image_size: int = 980
    num_channels: int = 3
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class ProjectorConfig:
    """Perceiver-style cross-attention resampler."""

    # ((num_patches, num_queries), ...): 1225 -> 128 for 490px, 4900 -> 256 for 980px
    patch_to_query: Tuple[Tuple[int, int], ...] = ((1225, 128), (4900, 256))
    embed_dim: int = 1152
    num_heads: int = 16
    kv_dim: int = 1152
    ff_dim: int = 2560
    output_dim: int = 2560
    layer_norm_eps: float = 1e-5

    @property
    def max_queries(self) -> int:
        return max(q for _, q in self.patch_to_query)

    def query_count(self, num_patches: int) -> int:
        for p, q in self.patch_to_query:
            if p == num_patches:
                return q
        raise ValueError(f"Query number for {num_patches} patches is not provided")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclass(frozen=True)
class TextConfig:
    """MoE decoder config."""

    vocab_size: int = 100352
    hidden_size: int = 2560
    num_layers: int = 28
    num_heads: int = 20
    num_kv_heads: int = 20
    head_dim: int = 128
    rope_base: float = 5_000_000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 65536
    # MoE
    num_experts: int = 64
    moe_topk: int = 6
    moe_intermediate_size: int = 1664
    num_shared_experts: int = 2
    moe_z_loss_coeff: float = 1e-5
    moe_aux_loss_coeff: float = 1e-3

    @property
    def shared_intermediate_size(self) -> int:
        return self.moe_intermediate_size * self.num_shared_experts

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim


@dataclass(frozen=True)
class AriaConfig:
    """Composite VLM config."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    text: TextConfig = field(default_factory=TextConfig)
    image_token_id: int = 9
    pad_token_id: int = 2

    @staticmethod
    def aria_25b() -> "AriaConfig":
        """The flagship 25.3B-total / 3.9B-active Aria shape."""
        return AriaConfig()

    @staticmethod
    def tiny() -> "AriaConfig":
        """A tiny shape for tests: same structure, toy dims."""
        return AriaConfig(
            vision=VisionConfig(
                hidden_size=32,
                num_layers=2,
                num_heads=2,
                intermediate_size=64,
                patch_size=14,
                image_size=98,
            ),
            projector=ProjectorConfig(
                patch_to_query=((49, 8), (16, 4)),
                embed_dim=32,
                num_heads=2,
                kv_dim=32,
                ff_dim=64,
                output_dim=64,
            ),
            text=TextConfig(
                vocab_size=512,
                hidden_size=64,
                num_layers=2,
                num_heads=4,
                num_kv_heads=4,
                head_dim=16,
                max_seq_len=512,
                num_experts=8,
                moe_topk=2,
                moe_intermediate_size=32,
                num_shared_experts=2,
            ),
        )

    def replace(self, **kw: Any) -> "AriaConfig":
        return dataclasses.replace(self, **kw)


def config_from_dict(d: Mapping[str, Any]) -> AriaConfig:
    """An AriaConfig from nested dicts (``dataclasses.asdict`` of an
    AriaConfig, or parsed JSON); lists become tuples."""

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, (list, tuple)) else v

    def build(cls, sub):
        return cls(**{k: tup(v) for k, v in sub.items()})

    return AriaConfig(
        vision=build(VisionConfig, d.get("vision", {})),
        projector=build(ProjectorConfig, d.get("projector", {})),
        text=build(TextConfig, d.get("text", {})),
        image_token_id=d.get("image_token_id", 9),
        pad_token_id=d.get("pad_token_id", 2),
    )
