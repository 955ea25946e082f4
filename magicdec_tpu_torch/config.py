"""Model configuration registry of the PyTorch port.

A copy of ``magicdec_tpu/config.py`` (the port imports nothing of the JAX
package): the same ``ModelConfig`` fields, model zoo, fuzzy name resolution
and ``tiny_config``, so a configuration means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def find_multiple(n: int, k: int) -> int:
    if n % k == 0:
        return n
    return n + k - (n % k)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Llama-family decoder config.

    ``rope_scaling_factor`` is linear positional-interpolation scaling unless the
    llama-3.1 NTK fields (``low_freq_factor``/``high_freq_factor``/
    ``original_max_position_embeddings``) are set, in which case the llama-3.1
    wavelength-dependent rule applies (reference: Engine/SnapKV/model.py:133-156).
    """

    name: str = "custom"
    block_size: int = 2048
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    dim: int = 4096
    intermediate_size: Optional[int] = None
    n_kv_head: int = -1  # reference calls this n_local_heads
    head_dim: int = 0    # 0: dim // n_head; kept by dataclasses.replace, so a
                         # tensor-parallel shard's config (its local head
                         # counts, parallel/sharding.py) keeps the model's
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    rope_scaling_factor: float = 1.0
    low_freq_factor: Optional[float] = None
    high_freq_factor: Optional[float] = None
    original_max_position_embeddings: Optional[int] = None
    qkv_bias: bool = False
    tie_word_embeddings: bool = False
    # Execution hint, NOT an architecture fact: engines set this (via
    # dataclasses.replace) on the cfg they pass to DECODE/VERIFY target
    # forwards, to the max row count any pass of that program family sees
    # (B * (gamma + 1)).  The port pads the rows of every target dot to this
    # count (models/llama.py matmul), so the baseline pass (M = B) and the
    # verify pass (M = B * (gamma + 1)) run GEMMs of one shape — the per-row
    # bit-identity the greedy spec == AR contract needs.  0 (the default,
    # and always on prefill and draft paths) keeps the live M.
    decode_rows: int = 0

    def __post_init__(self):
        if self.n_kv_head == -1:
            object.__setattr__(self, "n_kv_head", self.n_head)
        if self.intermediate_size is None:
            hidden_dim = 4 * self.dim
            n_hidden = int(2 * hidden_dim / 3)
            object.__setattr__(self, "intermediate_size", find_multiple(n_hidden, 256))
        if not self.head_dim:
            object.__setattr__(self, "head_dim", self.dim // self.n_head)

    @property
    def gqa_groups(self) -> int:
        return self.n_head // self.n_kv_head

    @property
    def uses_llama31_rope(self) -> bool:
        return self.low_freq_factor is not None and self.high_freq_factor is not None

    @classmethod
    def from_name(cls, name: str) -> "ModelConfig":
        if name in TRANSFORMER_CONFIGS:
            return cls(name=name, **TRANSFORMER_CONFIGS[name])
        matches = [key for key in TRANSFORMER_CONFIGS if key.lower() in str(name).lower()]
        if not matches:
            raise KeyError(f"no config matching {name!r}")
        if len(matches) > 1:
            matches.sort(key=len, reverse=True)
            if len(matches[0]) == len(matches[1]):
                raise ValueError(f"ambiguous config name {name!r}: {matches[:2]}")
        return cls(name=matches[0], **TRANSFORMER_CONFIGS[matches[0]])


# Same model zoo as the reference (Engine/SnapKV/model.py:60-79), expressed with
# our field names.  Values are architecture facts about public checkpoints.
TRANSFORMER_CONFIGS = {
    "llama-2-7b": dict(block_size=4096, n_layer=32, n_head=32, dim=4096),
    "llama-2-7b-32k": dict(block_size=32768, n_layer=32, dim=4096, vocab_size=32000,
                           rope_scaling_factor=8),
    "llama-2-13b": dict(block_size=4096, n_layer=40, n_head=40, dim=5120),
    "llama-2-70b": dict(block_size=4096, n_layer=80, n_head=64, dim=8192,
                        n_kv_head=8, intermediate_size=28672),
    "llama-3-8b": dict(block_size=8192, n_layer=32, n_head=32, n_kv_head=8, dim=4096,
                       intermediate_size=14336, vocab_size=128256, rope_base=500000.0),
    "llama-3-70b": dict(block_size=8192, n_layer=80, n_head=64, n_kv_head=8, dim=8192,
                        intermediate_size=28672, vocab_size=128256, rope_base=500000.0),
    "68m": dict(block_size=2048, n_layer=2, n_head=12, n_kv_head=12, dim=768,
                intermediate_size=3072, vocab_size=32000),
    "tinyllama": dict(block_size=2048, n_layer=22, n_head=32, n_kv_head=4, dim=2048,
                      intermediate_size=5632, vocab_size=32000),
    "llama-3.1-8b": dict(block_size=131072, n_layer=32, n_head=32, n_kv_head=8, dim=4096,
                         intermediate_size=14336, vocab_size=128256, rope_base=500000.0,
                         rope_scaling_factor=8, high_freq_factor=4, low_freq_factor=1,
                         original_max_position_embeddings=8192),
    "llama-3.1-70b": dict(block_size=131072, n_layer=80, n_head=64, n_kv_head=8, dim=8192,
                          intermediate_size=28672, vocab_size=128256, rope_base=500000.0,
                          rope_scaling_factor=8, high_freq_factor=4, low_freq_factor=1,
                          original_max_position_embeddings=8192),
    "llama-3.2-1b": dict(block_size=131072, n_layer=16, n_head=32, n_kv_head=8, dim=2048,
                         intermediate_size=8192, vocab_size=128256, rope_base=500000.0,
                         rope_scaling_factor=32, high_freq_factor=4, low_freq_factor=1,
                         original_max_position_embeddings=8192, tie_word_embeddings=True),
    "Qwen2.5-7b": dict(block_size=131072, n_layer=28, n_head=28, n_kv_head=4, dim=3584,
                       intermediate_size=18944, vocab_size=152064, rope_base=1000000.0,
                       qkv_bias=True, norm_eps=1e-6),
    "Qwen2.5-14b": dict(block_size=131072, n_layer=48, n_head=40, n_kv_head=8, dim=5120,
                        intermediate_size=13824, vocab_size=152064, rope_base=1000000.0,
                        qkv_bias=True, norm_eps=1e-6),
    "Qwen2.5-32b": dict(block_size=131072, n_layer=64, n_head=40, n_kv_head=8, dim=5120,
                        intermediate_size=27648, vocab_size=152064, rope_base=1000000.0,
                        qkv_bias=True, norm_eps=1e-6),
    "Yi-1.5-6b": dict(block_size=4096, n_layer=32, n_head=32, n_kv_head=4, dim=4096,
                      intermediate_size=11008, vocab_size=64000, rope_base=500000.0),
    "Yi-1.5-34b-32k": dict(block_size=32768, n_layer=60, n_head=56, n_kv_head=8, dim=7168,
                           intermediate_size=20480, vocab_size=64000, rope_base=500000.0),
    "Mistral-7B-v0.1": dict(n_layer=32, n_head=32, n_kv_head=8, dim=4096,
                            intermediate_size=14336, vocab_size=32000),
    "Mistral-7B-v0.3": dict(n_layer=32, n_head=32, n_kv_head=8, dim=4096,
                            intermediate_size=14336, vocab_size=32768, rope_base=1000000.0),
}


def tiny_config(vocab_size: int = 256, n_layer: int = 2, n_head: int = 4,
                n_kv_head: int = 2, dim: int = 64, intermediate_size: int = 128,
                block_size: int = 512, **kw) -> ModelConfig:
    """Small config for unit tests (not in the reference zoo)."""
    return ModelConfig(name="tiny", block_size=block_size, vocab_size=vocab_size,
                       n_layer=n_layer, n_head=n_head, n_kv_head=n_kv_head, dim=dim,
                       intermediate_size=intermediate_size, **kw)
