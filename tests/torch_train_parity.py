"""Shared by the port's training tests: run the JAX ``TrainEngine`` and the
port's on the same weights and batches, and hold the port to JAX.

``run_both`` builds both engines through each package's ``initialize``
(the JAX one on a one-device mesh), feeds them the same numpy batches and
records, per gradient element, the smallest |g| the port's optimizer
received (after averaging and clipping). ``assert_parity`` then checks
the losses, grad norms and the weights after the steps: every weight
within 2e-5 absolute, except elements whose gradient fell below 1e-7 at
some step. Adam moves a weight by about lr * sign(g) whatever |g| is,
except where |g| is near its eps (1e-8): there the step is about
lr * g / eps, so the fp32 summation noise of a gradient that cancels to
~1e-9 (XLA and PyTorch sum in other orders) reaches the weight. Those
elements are fewer than 1e-4 of all and within the most Adam can move
them (2 * sum of lr). A leaf
whose whole gradient stays below 1e-7 at every step is rounding noise
throughout (the attention's key bias: a row's softmax does not change
when q . b_k is added to every logit, so its true gradient is 0); its
elements are held by the Adam bound alone and not counted.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.parallel.mesh import Topology
from deepspeed_tpu_torch.runtime import optimizers as opt

CFG = {
    "train_batch_size": 4,
    "train_micro_batch_size_per_gpu": 2,
    "gradient_clipping": 0.5,
    "steps_per_print": 100,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 1e-2, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupDecayLR",
                  "params": {"total_num_steps": 10, "warmup_num_steps": 2,
                             "warmup_max_lr": 1e-2}},
}


def flat_jax(tree, prefix=""):
    """A JAX parameter tree as ``{port name: numpy array}``: stacked
    ``layers`` leaves become ``layers.{i}.{leaf}``, nested towers
    ``text.`` / ``vision.`` prefixes."""
    out = {}
    for key, val in tree.items():
        if key == "layers":
            for leaf, stacked in val.items():
                for i, a in enumerate(np.asarray(stacked)):
                    out[f"{prefix}layers.{i}.{leaf}"] = a
        elif isinstance(val, dict):
            out.update(flat_jax(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _metrics(m):
    return {k: float(np.asarray(v)) for k, v in m.items()}


def run_both(jm, jparams, tm, batches, cfg=CFG, port_cfg=None):
    """(JAX engine, port engine, [(JAX metrics, port metrics)] per step,
    {name: (smallest |g| of each element, largest |g| of the leaf) over
    the steps, as the port's optimizer received them}). ``batches`` are
    dicts of numpy arrays; ``port_cfg`` (default ``cfg``) is the port
    engine's config."""
    jeng, *_ = deepspeed_tpu.initialize(
        model=jm, params=jparams, config=cfg,
        topology=Topology.build_virtual({"data": 1}))
    teng, _, loader, schedule = deepspeed_tpu_torch.initialize(
        model=tm, config=cfg if port_cfg is None else port_cfg, device="cpu")
    assert loader is None and schedule is teng.lr_schedule
    min_abs_g = {}
    inner = teng.optimizer

    def update(grads, state, params):
        for n, g in grads.items():
            a = g.abs()
            lo, hi = min_abs_g.get(n, (a, 0.0))
            min_abs_g[n] = (torch.minimum(lo, a), max(hi, a.max().item()))
        return inner.update(grads, state, params)

    teng.optimizer = opt.Transform(inner.init, update,
                                   separable=inner.separable)
    steps = []
    for batch in batches:
        jm_ = jeng.train_batch({k: jnp.asarray(v) for k, v in batch.items()})
        tm_ = teng.train_batch({k: torch.from_numpy(np.asarray(v))
                                for k, v in batch.items()})
        steps.append((_metrics(jm_), _metrics(tm_)))
    return jeng, teng, steps, min_abs_g


def assert_parity(jeng, teng, steps, min_abs_g, rtol=1e-5):
    """Losses and grad norms within ``rtol``, no skipped step, and the
    weights after the steps as the module docstring says. Returns the
    number of elements held only by the near-eps rule."""
    for j, t in steps:
        assert t["skipped"] == j["skipped"] == 0
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=rtol)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=rtol)
    assert teng.global_steps == len(steps)
    lr_sum = sum(teng.lr_schedule(c) for c in range(1, len(steps) + 1))
    ref = flat_jax(jax.tree_util.tree_map(np.asarray, jeng.params))
    return assert_weights({n: w.detach().numpy()
                           for n, w in teng.params.items()}, ref,
                          {n: (g.numpy(), hi)
                           for n, (g, hi) in min_abs_g.items()}, lr_sum)


def assert_weights(got, ref, min_abs_g, lr_sum, atol=2e-5):
    """The weights ``got`` against ``ref`` (both ``{port name: numpy}``)
    as the module docstring says (``atol`` in place of its 2e-5 where a
    caller holds them closer), ``min_abs_g`` ``{name: (smallest |g| of
    each element, largest |g| of the leaf)}`` over the steps and
    ``lr_sum`` the learning rates' sum. Returns the number of elements
    held only by the near-eps rule."""
    assert set(ref) == set(got)
    n_out, n_all = 0, 0
    for name, w in got.items():
        d = np.abs(w - ref[name])
        g, hi = min_abs_g[name]
        out = d > atol
        assert np.all(g[out] < 1e-7), (name, d[out], g[out])
        assert np.all(d <= 2 * lr_sum), name
        if hi >= 1e-7:
            n_out += int(out.sum())
        n_all += d.size
    assert n_out <= 1e-4 * n_all, (n_out, n_all)
    return n_out
