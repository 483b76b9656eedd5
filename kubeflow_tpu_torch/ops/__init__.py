"""Compute ops of the port: the attention family.

  * ``attention`` — dense MHA, the reference implementation;
  * ``flash_attention`` — hand-written Hopper forward kernel, blockwise
    backward.

Ring attention, Ulysses and MoE are not ported yet (ROADMAP Queue 1).
"""

from .attention import multihead_attention  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
