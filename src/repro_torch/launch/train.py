"""Training driver, as the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --smoke --steps 50 --batch 4 --seq 64 --ckpt-dir /tmp/ckpt --device cpu

Trains on the card unless ``--device`` says otherwise (with no CUDA
device, ``cuda`` raises: there is no fallback), in float32 as the JAX
driver forces, with random weights from seed 0 and the synthetic stream
of :class:`~repro_torch.training.SyntheticLM`. Checkpoints land every
``--ckpt-every`` steps and restore automatically on restart: kill it
mid-run and relaunch. Every step prints one line with its loss at full
precision.

``--mesh single`` trains on ``make_production_mesh()``'s ``(data,
model)`` mesh, ``--mesh multi`` on its ``(pod=2, data, model)`` one, under
``TRAIN_RULES`` (:func:`~repro_torch.models.parallel.place_train`: FSDP
over ``data``, tensor parallelism over ``model``, sequence parallelism on
the residual stream), as the JAX driver's ``use_mesh_rules(mesh,
TRAIN_RULES)``; ``--mesh host`` (the default) on one device. The mesh's
positions are the visible cards, or, with ``--positions N``, the named
``--device`` repeated N times (``--device cpu --positions 4``, or
``cuda:0``; a bare ``cuda`` takes the first N visible cards): the
counterpart of the JAX driver under
``XLA_FLAGS=--xla_force_host_platform_device_count=N``. Four positions
give ``single`` (data 2, model 2) and ``multi`` (pod 2, data 2, model 1),
by the mesh's square-root rule. A checkpoint holds the logical tree, so
it restores on any mesh.
Every family of the registry trains on the card: the attention families
(dense, MoE, internvl2's backbone, the encoder-decoders) through the
flash-attention backward kernel, the Mamba and hybrid ones also through
the selective-scan backward kernel. An encoder-decoder's batches carry
frames (``make_batch``), as JAX's.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import ARCH_NAMES, get_config, get_smoke_config
from ..device import resolve_device
from ..distributed.sharding import Mesh
from ..ft.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..models import build_model, init_from_template
from ..models.common import ModelConfig, tree_leaves
from ..models.parallel import place_train
from .mesh import make_production_mesh
from ..training import (
    AdamWConfig,
    SyntheticLM,
    init_train_state,
    make_batch,
    make_train_step,
)

__all__ = ["main", "train"]


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int, lr: float,
          ckpt_dir: str | None = None, ckpt_every: int = 20,
          device: str | torch.device | None = None, mesh: Mesh | None = None,
          report: dict | None = None) -> list[dict]:
    """Train ``cfg`` (forced to float32) from seed 0 for ``steps`` steps,
    resuming from the newest checkpoint in ``ckpt_dir``. Returns one dict of
    floats per step run here: ``step`` (1-based), ``loss``, ``ce``,
    ``lb_loss``, ``grad_norm``, ``lr``, and the step's wall ``seconds``
    (reading the metrics waits for the device).

    With ``mesh`` (a training mesh, :func:`.mesh.make_production_mesh`)
    the weights drawn on its first position's device are placed by
    ``TRAIN_RULES`` and every step runs on the mesh; ``device`` is then
    that first position's. ``report``, if given, receives
    ``position_bytes``: per position (one without a mesh), the bytes of its
    params and both moments; ``counter_bytes``: the update count's and the
    step's; and ``batch_bytes``: the first step's batch's."""
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    device = resolve_device(mesh.devices.flat[0] if mesh is not None else device)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_from_template(model.template, gen, cfg.param_dtype, device=device)
    if mesh is not None:
        params = place_train(cfg, model.template, params, mesh)
    state = init_train_state(model, params)
    if report is not None:
        if mesh is not None:
            report["position_bytes"] = [sum(parts) for parts in zip(
                params.position_bytes(), state.opt["m"].position_bytes(),
                state.opt["v"].position_bytes())]
        else:
            report["position_bytes"] = [sum(t.numel() * t.element_size() for tree in (
                params, state.opt["m"], state.opt["v"]) for t in tree_leaves(tree))]
        report["counter_bytes"] = sum(t.numel() * t.element_size()
                                      for t in (state.opt["count"], state.step))
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        state, start = restore_checkpoint(ckpt_dir, state)
        print(f"restored checkpoint at step {start}", flush=True)
    step_fn = make_train_step(model, opt_cfg)

    history = []
    t0 = t_step = time.perf_counter()
    for i in range(start, steps):
        batch = make_batch(cfg, data, i, device=device)
        if report is not None and i == start:
            report["batch_bytes"] = sum(t.numel() * t.element_size() for t in batch.values())
        state, metrics = step_fn(state, batch)
        row = {"step": i + 1, **{k: float(v) for k, v in metrics.items()}}
        row["seconds"], t_step = time.perf_counter() - t_step, time.perf_counter()
        history.append(row)
        print(f"step {i + 1:4d} loss={row['loss']!r} gnorm={row['grad_norm']:.4f} "
              f"lr={row['lr']:.3e}", flush=True)
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, i + 1, state)
            print(f"saved checkpoint at step {i + 1}", flush=True)
    print(f"done: {steps - start} steps in {time.perf_counter() - t0:.1f}s", flush=True)
    return history


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh", choices=["host", "single", "multi"], default="host")
    ap.add_argument("--positions", type=int, default=None,
                    help="mesh positions: --device repeated this many times (a bare cuda: "
                         "the first N visible cards); default every visible card")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.positions is not None and args.mesh == "host":
        ap.error("--positions needs --mesh single or multi")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = None
    if args.mesh != "host":
        device = resolve_device(args.device)
        devices = None  # every visible card
        if device.type != "cuda" or device.index is not None:
            devices = [device] * (args.positions or 1)  # a named device at every position
        elif args.positions is not None:
            devices = [torch.device("cuda", i) for i in range(args.positions)]
        mesh = make_production_mesh(multi_pod=args.mesh == "multi", devices=devices)
        print(f"mesh: {mesh.shape} over {[str(d) for d in mesh.devices.flat]}", flush=True)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, device=args.device, mesh=mesh)


if __name__ == "__main__":
    main()
