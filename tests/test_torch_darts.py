"""Port parity: kubeflow_tpu_torch's Katib DARTS trial worker against the
JAX package's.

The workers draw their weights, target and batches from different
generators, so their printouts differ; the parity test feeds the same
numpy-seeded weights, architecture logits, target and batches to the port's
``search_step`` and to the JAX worker's bilevel step.  That step is a
closure inside ``kubeflow_tpu/examples/darts_worker.py:main`` (lines 62-98),
so the test carries it over line for line, under a jit of its own.

Run as a script, this file sweeps seeds through both workers and prints how
often each recovers the all-``relu_linear`` genotype:

    JAX_PLATFORMS=cpu python tests/test_torch_darts.py 16 64
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, DIM = 4, 16
# f32 on both sides, the same graph summed in another order: the
# reference's f32 bound (1e-5), over three Adam steps whose normalised
# updates (3e-3 and 3e-2 a step) are insensitive to the last bits
TOL = 1e-5
# of the seeds 0-63 whose search recovers the genotype on the CPU, the one
# whose final architecture logits part widest (the smallest top-2 margin
# over the layers, 0.0396): the search recovers it for 11 of 64 seeds in
# the port and 14 of 64 in the JAX worker at these settings, the JAX
# worker's seed 0 among them and the port's not (the sweep above; ROADMAP
# Queue 1)
GENOTYPE_SEED = 37


def _jax_step():
    import jax
    import jax.numpy as jnp
    import optax

    def mixed_layer(h, w_lin, w_relu, a, tau):
        p = jax.nn.softmax(a / tau)
        return (p[0] * (h @ w_lin) + p[1] * jax.nn.relu(h @ w_relu) + p[2] * h
                + p[3] * jnp.zeros_like(h))

    def forward(weights, alphas, x, tau):
        h = x
        for l in range(L):
            h = mixed_layer(h, weights["linear"][l], weights["relu_linear"][l], alphas[l], tau)
        return h

    def loss(weights, alphas, tgt, x, tau=1.0):
        h = x
        for l in range(L):
            h = jax.nn.relu(h @ tgt[l])
        return jnp.mean((forward(weights, alphas, x, tau) - h) ** 2)

    w_opt, a_opt = optax.adam(3e-3), optax.adam(3e-2)

    @jax.jit
    def step(weights, alphas, w_state, a_state, tgt, x_train, x_val, tau):
        wl, w_grads = jax.value_and_grad(loss)(weights, alphas, tgt, x_train, tau)
        w_updates, w_state = w_opt.update(w_grads, w_state)
        weights = optax.apply_updates(weights, w_updates)
        vl, a_grads = jax.value_and_grad(loss, argnums=1)(weights, alphas, tgt, x_val, tau)
        a_updates, a_state = a_opt.update(a_grads, a_state)
        alphas = optax.apply_updates(alphas, a_updates)
        return weights, alphas, w_state, a_state, wl, vl

    return step, w_opt, a_opt


def test_search_steps_match_jax():
    import jax.numpy as jnp

    from kubeflow_tpu_torch.examples import darts_worker as W
    from kubeflow_tpu_torch.train.trainer import adam

    rng = np.random.default_rng(0)
    w_np = {k: (rng.standard_normal((L, DIM, DIM)) * 0.3).astype(np.float32)
            for k in ("linear", "relu_linear")}
    tgt_np = (rng.standard_normal((L, DIM, DIM)) * 0.3).astype(np.float32)
    a_np = (rng.standard_normal((L, len(W.OPS))) * 0.1).astype(np.float32)
    data = [(rng.standard_normal((W.BATCH, DIM)).astype(np.float32),
             rng.standard_normal((W.BATCH, DIM)).astype(np.float32)) for _ in range(3)]

    step, w_opt, a_opt = _jax_step()
    jw = {k: jnp.asarray(v) for k, v in w_np.items()}
    ja = jnp.asarray(a_np)
    jws, jas = w_opt.init(jw), a_opt.init(ja)
    tw = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in w_np.items()}
    ta = torch.from_numpy(a_np.copy()).requires_grad_()
    tw_opt, ta_opt = adam(3e-3), adam(3e-2)
    tws, tas = tw_opt.init(tw), ta_opt.init({"alphas": ta})
    tgt = torch.from_numpy(tgt_np)
    for i, (xt, xv) in enumerate(data):
        tau = W.tau_at(i, 3)
        jw, ja, jws, jas, jwl, jvl = step(jw, ja, jws, jas, jnp.asarray(tgt_np), xt, xv,
                                          jnp.float32(tau))
        twl, tvl = W.search_step(tw, ta, tw_opt, tws, ta_opt, tas, tgt,
                                 torch.from_numpy(xt), torch.from_numpy(xv), tau)
        np.testing.assert_allclose(float(twl), float(jwl), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(tvl), float(jvl), rtol=TOL, atol=TOL)
    for k in tw:
        np.testing.assert_allclose(tw[k].detach().numpy(), np.asarray(jw[k]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), rtol=TOL, atol=TOL)


def test_worker_recovers_the_relu_linear_genotype():
    env = dict(os.environ, TORCH_DEVICE="cpu", NUM_LAYERS="4", SEARCH_STEPS="300",
               SEED=str(GENOTYPE_SEED), PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.examples.darts_worker"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    geno = next(line for line in lines if line.startswith("genotype="))
    assert json.loads(geno.split("=", 1)[1]) == ["relu_linear"] * 4
    assert [line.split("=")[0] for line in lines[-4:]] == ["genotype", "val_acc",
                                                            "discretized_loss", "DARTS-OK"]
    assert 0.0 < float(lines[-3].split("=")[1]) <= 1.0
    assert sum(line.startswith("step=") for line in lines) == 6  # every 50 steps


def _sweep(which: str, seeds) -> list:
    """(genotype, the smallest top-2 margin of the final architecture
    logits or None) each worker's search ends at, seed by seed, in-process;
    the margins are read from the port's worker only."""
    os.environ.update(NUM_LAYERS="4", SEARCH_STEPS="300", TORCH_DEVICE="cpu")
    alphas = {}
    if which == "jax":
        from kubeflow_tpu.examples.darts_worker import main
    else:
        from kubeflow_tpu_torch.examples import darts_worker as W

        step = W.search_step

        def watched(weights, a, *args):
            alphas["last"] = a
            return step(weights, a, *args)

        W.search_step = watched
        main = W.main
    out = []
    for s in seeds:
        os.environ["SEED"] = str(s)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main()
        geno = next(x for x in buf.getvalue().splitlines() if x.startswith("genotype="))
        top2 = alphas["last"].detach().topk(2, dim=1).values if alphas else None
        out.append((json.loads(geno.split("=", 1)[1]),
                    None if top2 is None else float((top2[:, 0] - top2[:, 1]).min())))
    return out


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    seeds = range(int(sys.argv[1]), int(sys.argv[2]))
    for which in ("port", "jax"):
        res = _sweep(which, seeds)
        full = {s: m for s, (g, m) in zip(seeds, res) if g == ["relu_linear"] * 4}
        print(json.dumps({"worker": which, "seeds": [seeds.start, seeds.stop],
                          "recovered": len(full), "of": len(res),
                          "recovered_seeds_min_margin": full,
                          "off_per_layer": [sum(g[i] != "relu_linear" for g, _ in res)
                                            for i in range(4)]}))
