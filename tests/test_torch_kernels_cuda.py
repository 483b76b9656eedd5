"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX package,
so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the CPU suite.)
The parity of the plain versions with the JAX package's TPU kernels is
tests/test_torch_paged_attention.py's job."""

import pytest
import torch

from kubeflow_tpu_torch.serving.engine import model as M
from kubeflow_tpu_torch.serving.engine import paged_attention as PA

B, Hq, Hkv, hd, ps, P, MP = 4, 8, 2, 128, 32, 40, 8
SEQ_LENS = [256, 0, 33, 97]  # a full slot, an idle slot, partial last pages

# (pool kind, q dtype, rtol, atol).  f32 everywhere: both sides compute in
# f32 and differ only in summation order.  bf16 q (output in bf16): one
# bf16 ulp of the output (2**-7 relative) plus 1e-3 for outputs near zero.
CASES = [("f32", torch.float32, 1e-5, 1e-5), ("bf16", torch.bfloat16, 2.0 ** -7, 1e-3),
         ("int8", torch.bfloat16, 2.0 ** -7, 1e-3)]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("kind,q_dtype,rtol,atol", CASES, ids=[c[0] for c in CASES])
def test_paged_attention_kernel_matches_plain(card, kind, q_dtype, rtol, atol, K):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, K, Hq, hd), generator=g).to(card, q_dtype)

    def pool():
        x = torch.randn((P, Hkv, ps, hd), generator=g)
        if kind == "int8":
            qv, s = M._quantize_kv(x.to(torch.bfloat16))
            return {"q": qv.to(card), "s": s.to(card)}
        return x.to(card, torch.float32 if kind == "f32" else torch.bfloat16)

    k_pool, v_pool = pool(), pool()
    table = torch.randint(1, P, (B, MP), generator=g, dtype=torch.int32).to(card)
    lens = torch.tensor(SEQ_LENS, dtype=torch.int32, device=card)
    before = PA.paged_attention.launches
    out = PA.paged_attention(q, k_pool, v_pool, table, lens, ps)
    ref = PA.paged_attention_plain(q, k_pool, v_pool, table, lens, ps)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    if K == 1:
        assert torch.all(out[1] == 0)  # the idle slot visits no page
