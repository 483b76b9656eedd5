"""JetStream-class inference engine on PyTorch/CUDA: C++ continuous batcher +
paged-KV decode with a hand-written Hopper paged-attention kernel."""

from ..errors import RequestError  # noqa: F401  (re-export)
from .engine import Engine, EngineConfig  # noqa: F401
from .model import DecoderConfig  # noqa: F401
