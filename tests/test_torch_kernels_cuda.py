"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX package,
so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the CPU suite.)
The parity of the plain versions with the JAX package's TPU kernels is
tests/test_torch_paged_attention.py's and tests/test_torch_flash_attention.py's
job."""

import importlib

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


# ------------------------------------------------------------ flash attention

FA = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
FB, FS, FH = 2, 96, 3  # S = 96: the kernel's second 64-row query tile is half full
# (dtype, rtol, atol).  f32: both sides in f32, summation order only.  bf16:
# one bf16 ulp of the output (2**-7 relative) plus 1e-3 near zero; lse is f32
# on both sides.
FLASH_CASES = [(torch.float32, 1e-5, 1e-5), (torch.bfloat16, 2.0 ** -7, 1e-3)]


def _flash_mask(kind, card):
    if kind is None:
        return None
    am = torch.ones((FB, FS), device=card)
    if kind == "ragged":
        am[0, 50:] = 0
    else:  # "left": under causal, batch 1's first 40 query rows see no key
        am[1, :40] = 0
    return am


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", [None, "ragged", "left"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("dtype,rtol,atol", FLASH_CASES, ids=["f32", "bf16"])
def test_flash_attention_kernel_matches_plain(card, dtype, rtol, atol, D, causal, mask_kind):
    g = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn((FB * FH, FS, D), generator=g).to(card, dtype) for _ in range(3))
    am = _flash_mask(mask_kind, card)
    mask = None if am is None else am.reshape(FB, 1, FS)
    args = (q, k, v, mask, D ** -0.5, causal, 32, 32)
    before = FA.flash_attention.launches
    out, lse = FA._flash_fwd(*args[:-2], 32, 32, FH)
    ref, ref_lse = FA.flash_attention_plain(*args)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_backward_on_card_matches_cpu(card):
    """One backward through the autograd Function on the card (kernel
    forward, blockwise f32 backward) against the same Function on CPU copies
    (plain forward)."""
    g = torch.Generator().manual_seed(1)
    x = [torch.randn((FB, FS, FH, 64), generator=g) for _ in range(4)]
    am = torch.ones((FB, FS))
    am[1, :40] = 0

    def run(dev):
        q, k, v = (t.to(dev).requires_grad_() for t in x[:3])
        out = FA.flash_attention(q, k, v, causal=True, block_q=32, block_k=32,
                                 kv_mask=am.to(dev))
        (out * x[3].to(dev)).sum().backward()
        return [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]

    before = FA.flash_attention.launches
    got = run(card)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    for a, b in zip(got, run("cpu")):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
