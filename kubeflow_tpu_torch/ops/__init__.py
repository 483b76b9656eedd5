"""Compute ops of the port: the attention family and MoE.

  * ``attention`` — dense MHA, the reference implementation;
  * ``flash_attention`` — hand-written Hopper forward kernel, blockwise
    backward;
  * ``ring_attention`` — context parallelism over the ``seq`` axis;
  * ``ulysses`` — head all-to-all sequence parallelism;
  * ``shard_map_compat`` — ``shard_map`` and the collectives over shards;
  * ``moe`` — the Mixture-of-Experts FFN, expert-parallel on a mesh.
"""

from .attention import multihead_attention  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
from .moe import MoEConfig, init_moe, moe_ffn  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
