"""Port parity: ``Trainer.compiled_cost_analysis`` (``train/trainer.py``).

The reference returns XLA's cost model for the compiled step, or ``{}``.
The port counts one forward and backward with ``torch.utils.flop_counter``,
the flash kernel entering at its own products (``ops.flash_attention.
counting_flops``), so that:
- the count leaves params, the optimizer state, the step counter and the
  RNG bit-identical, and the next ``train_step`` is the one it would have
  been;
- ``attention="flash"`` and ``"dense"`` count the same to 1% (exactly, on
  the CPU: the same products);
- the count equals ``BertConfig.train_flops(B, S)`` (every position through
  the MLM head, as ``mlm_loss`` computes it) within 1e-6 relative: both
  count 6·N·tokens of matmuls plus 12·B·S²·H of attention;
- a failing loss gives ``{}`` and never raises.
The JAX Trainer's XLA figure on the same config is printed beside it and
not compared: XLA's cost model counts its compiled HLO, not the model's
products (1.507e8 against the port's 1.825e8 here, CPU figures).  A ``cuda``
test holds flash against dense on the card, where the kernel itself runs."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import bert as tbert
from kubeflow_tpu_torch.train import data as tdata
from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

CFG = tbert.BertConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                       intermediate_size=128, max_position=64)
B, S = 4, 64
FLASH_DENSE_RTOL = 1e-2     # the issue's gate: either path counts the same
TRAIN_FLOPS_RTOL = 1e-6     # same products, summed in another order


def _trainer(cfg, device="cpu"):
    model = tbert.init(cfg, device, seed=0)
    return Trainer(lambda m, b: tbert.mlm_loss(m, cfg, b["input_ids"], b["labels"],
                                               b["attention_mask"]),
                   model, TrainerConfig(warmup_steps=2, total_steps=10), device=device)


def _batch(seed=0):
    batch = next(tdata.synthetic_mlm_batches(CFG.vocab_size, B, S, seed=seed))
    batch["attention_mask"][:, S - 9:] = 0  # ragged padding
    return batch


def _snapshot(tr):
    return ({n: p.detach().clone() for n, p in tr.params.items()},
            {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
             for k, v in tr.opt_state.items()},
            tr.step_num, torch.get_rng_state())


def _same(a, b):
    pa, oa, sa, ra = a
    pb, ob, sb, rb = b
    assert sa == sb and torch.equal(ra, rb)
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    for k in oa:
        if isinstance(oa[k], dict):
            assert all(torch.equal(oa[k][n], ob[k][n]) for n in oa[k])
        else:
            assert oa[k] == ob[k]


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_count_leaves_the_trainer_as_it_was(attention):
    cfg = dataclasses.replace(CFG, attention=attention)
    tr, twin = _trainer(cfg), _trainer(cfg)
    tr.train_step(_batch(1))
    twin.train_step(_batch(1))
    before = _snapshot(tr)
    cost = tr.compiled_cost_analysis(_batch(2))
    assert set(cost) == {"flops"} and cost["flops"] > 0
    _same(before, _snapshot(tr))
    # the next step is the step the twin (never counted) takes
    got, want = tr.train_step(_batch(3)), twin.train_step(_batch(3))
    assert got["loss"] == want["loss"] and got["grad_norm"] == want["grad_norm"]
    assert all(torch.equal(tr.params[n], twin.params[n]) for n in tr.params)


def test_flash_counts_as_dense_and_as_train_flops():
    counts = {a: _trainer(dataclasses.replace(CFG, attention=a)).compiled_cost_analysis(
        _batch())["flops"] for a in ("flash", "dense")}
    assert counts["flash"] == pytest.approx(counts["dense"], rel=FLASH_DENSE_RTOL)
    assert counts["flash"] == counts["dense"]
    want = CFG.train_flops(B, S)
    assert counts["flash"] == pytest.approx(want, rel=TRAIN_FLOPS_RTOL)
    print(f"port flops {counts['flash']:.6e} train_flops {want:.6e}  "
          f"(JAX XLA figure: {_jax_xla_flops():.6e}; CPU figures)")


def _jax_xla_flops() -> float:
    """The reference's XLA cost figure for the same config, for the record."""
    import jax

    from kubeflow_tpu.models import bert as jbert
    from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
    from kubeflow_tpu.train.trainer import Trainer as JTrainer
    from kubeflow_tpu.train.trainer import TrainerConfig as JTC

    jcfg = jbert.BertConfig(vocab_size=CFG.vocab_size, hidden_size=CFG.hidden_size,
                            num_layers=CFG.num_layers, num_heads=CFG.num_heads,
                            intermediate_size=CFG.intermediate_size,
                            max_position=CFG.max_position)
    params = jbert.init(jax.random.PRNGKey(0), jcfg)

    def loss_fn(p, b):
        return jbert.mlm_loss(p, jcfg, b["input_ids"], b["labels"], b["attention_mask"])

    mesh = build_mesh(MeshConfig(data=1, fsdp=1, tensor=1), jax.devices()[:1])
    tr = JTrainer(loss_fn, params, mesh, jbert.SHARDING_RULES,
                  JTC(warmup_steps=2, total_steps=10))
    return float(tr.compiled_cost_analysis(tr.put_batch(_batch())).get("flops", float("nan")))


def test_a_failing_count_returns_empty_and_training_goes_on():
    tr = _trainer(CFG)

    def broken(m, b):
        raise RuntimeError("no count here")

    real = tr.loss_fn
    tr.loss_fn = broken
    assert tr.compiled_cost_analysis(_batch()) == {}
    tr.loss_fn = real
    assert np.isfinite(tr.train_step(_batch())["loss"])


def test_flop_counts_do_not_nest():
    import importlib

    fa = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
    with fa.counting_flops():
        with pytest.raises(RuntimeError, match="already open"):
            with fa.counting_flops():
                pass
    assert fa._TALLY is None


@pytest.mark.cuda
def test_flash_counts_as_dense_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel runs only there")
    import importlib

    fa = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
    cfg = tbert.BertConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                           intermediate_size=512, max_position=128)
    counts = {}
    for a in ("flash", "dense"):
        c = dataclasses.replace(cfg, attention=a)
        tr = _trainer(c, device="cuda")
        n0 = fa.flash_attention.launches
        batch = next(tdata.synthetic_mlm_batches(c.vocab_size, 4, 128, seed=0))
        counts[a] = tr.compiled_cost_analysis(batch)["flops"]
        if a == "flash":
            assert fa.flash_attention.launches == n0 + c.num_layers
    assert counts["flash"] == pytest.approx(counts["dense"], rel=FLASH_DENSE_RTOL)
    assert counts["flash"] == pytest.approx(cfg.train_flops(4, 128), rel=TRAIN_FLOPS_RTOL)
