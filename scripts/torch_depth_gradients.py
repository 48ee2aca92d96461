#!/usr/bin/env python3
"""The step-0 gradient of the train loss, layer by layer, in the JAX
package and in the port at depths 3, 12 and 24 (smoke widths, fp32), on
the CPU. Like the port's tests it imports both packages: the port gets
JAX's weights (``params_from_numpy``) and JAX's batches.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_depth_gradients.py [--out FILE]

For each model, depth and batch it prints one JSON object per line: both
packages' gradient norms over the layer stacks, layer 0's norm over the last layer's (JAX's), the
worst ratio of a layer's norm between the packages, and, at 24 layers,
how far JAX's own norm moves when each of its weights is moved by one
ulp (three draws of the signs). That last spread is what fp32 rounding
alone does to the gradient at that depth. Takes ~2 minutes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import init_from_template as jax_init
from repro.training import SyntheticLM, cross_entropy, make_batch
from repro.training.train_loop import MOE_AUX_WEIGHT
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models.common import tree_flatten_with_names
from repro_torch.training.train_loop import loss_and_grad

FP32 = dict(dtype="float32", param_dtype="float32")


def layer_norms(named, n_layers: int) -> np.ndarray:
    """The gradient's norm over each layer's slice of the layer stacks."""
    sq = np.zeros(n_layers)
    for name, g in named:
        if name.startswith("['classes']"):
            sq += (np.asarray(g, np.float64).reshape(n_layers, -1) ** 2).sum(1)
    return np.sqrt(sq)


def jax_layer_norms(jmodel, params, batch, n_layers: int) -> np.ndarray:
    def loss_fn(p):
        logits, aux = jmodel.forward(p, batch)
        loss = cross_entropy(logits, batch["labels"])
        return loss + MOE_AUX_WEIGHT * aux["lb_loss"] if jmodel.cfg.is_moe else loss

    grads = jax.grad(loss_fn)(params)
    return layer_norms([(jax.tree_util.keystr(p), g)
                        for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]], n_layers)


def one_ulp(tree, seed: int):
    """Every weight moved by one fp32 ulp up or down (signs drawn)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a * (1 + np.float32(2**-23)
                                       * rng.choice([-1, 1], a.shape).astype(np.float32)), tree)


def measure(arch: str, n_layers: int, step: int, spread: bool) -> dict:
    """One JSON row: ``arch``'s smoke config cut or grown to ``n_layers``
    layers, on batch ``step`` (B=4, S=64); ``spread`` adds JAX's one-ulp runs."""
    jmodel = jax_build_model(dataclasses.replace(jax_smoke_config(arch), **FP32,
                                                 n_layers=n_layers))
    tree = jax.tree.map(np.asarray, jax_init(jmodel.template, jax.random.PRNGKey(0), "float32"))
    data = SyntheticLM(vocab_size=jmodel.cfg.vocab_size, seq_len=64, global_batch=4)
    batch = jax.tree.map(np.asarray, make_batch(jmodel.cfg, data, step))
    jbatch = jax.tree.map(jnp.asarray, batch)
    want = jax_layer_norms(jmodel, jax.tree.map(jnp.asarray, tree), jbatch, n_layers)
    tmodel = build_model(dataclasses.replace(get_smoke_config(arch), **FP32, n_layers=n_layers))
    (_, _), grads = loss_and_grad(tmodel, params_from_numpy(tree, device="cpu"),
                                  {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    got = layer_norms([(n, g.detach().numpy()) for n, g in tree_flatten_with_names(grads)],
                      n_layers)
    row = {"arch": arch, "layers": n_layers, "batch_step": step,
           "jax_layer_norm": float(np.sqrt((want ** 2).sum())),
           "port_layer_norm": float(np.sqrt((got ** 2).sum())),
           "jax_layer0_over_last": float(want[0] / want[-1]),
           "port_layer0_over_last": float(got[0] / got[-1]),
           "worst_layer_ratio": float(np.max(np.maximum(got / want, want / got)))}
    if spread:
        moved = [np.sqrt((jax_layer_norms(jmodel, jax.tree.map(jnp.asarray, one_ulp(tree, s)),
                                          jbatch, n_layers) ** 2).sum()) for s in range(3)]
        row["jax_one_ulp_norm_ratios"] = [float(m / row["jax_layer_norm"]) for m in moved]
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="append the JSON lines here too")
    args = ap.parse_args()
    for arch in ("stablelm-1.6b", "granite-moe-1b-a400m"):
        for n_layers in (3, 12, 24):
            for step in (0, 1, 2):
                line = json.dumps(measure(arch, n_layers, step, spread=n_layers == 24))
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")


if __name__ == "__main__":
    main()
