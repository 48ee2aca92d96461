"""The port's training mesh (``TRAIN_RULES``: FSDP over ``data``, tensor
parallelism over ``model``, sequence parallelism on the residual stream)
against the JAX package's mesh train step and the port's own
single-device step, on the CPU, fp32, smoke configs, B = 4, S = 16.

* **Against JAX.** JAX runs ``make_train_step``'s step (its gradient
  returned beside it) under ``use_mesh_rules(mesh, TRAIN_RULES)`` with
  the train state placed by ``param_shardings(TRAIN_RULES)``, as
  ``launch/dryrun.py`` lays it out, in subprocesses with 4 forced host
  devices; the weights (JAX's init) and batches (JAX's) go to both as
  numpy, to the port through ``convert.py``. Every family for 3 steps on (2, 2), and
  stablelm on (pod 2, data 1, model 2), with the tolerances of
  ``tests/test_torch_training.py::test_train_steps_match_jax`` and, for
  step 0's gradient gathered from the shards, of
  ``test_gradients_match_jax``: a value JAX itself resolves only coarser
  is held to RESOLUTION_FACTOR times JAX's own widest move under
  ULP_MOVES one-ulp moves of its weights, measured on its mesh.
* **Against the port's single-device step**, on (1, 2), (2, 1), (2, 2)
  and (1, 4) for every family, and on (2, 2) with B = 3, S = 15 (neither
  dim divides: the batch and the sequence are replicated). Only the order
  of the sums differs; the same resolution rule, measured on the port's
  own single-device step.
* **Layout.** Every leaf of every smoke config on (2, 2) and (2, 1, 2):
  each shard's shape is the one JAX's ``param_shardings(TRAIN_RULES)``
  gives.
* **Invariants.** Two mesh steps from one state are bit-identical;
  replicated leaves and their moments stay bit-identical on every
  position; MoE routing on (2, 2) takes the single device's assignments;
  the clip scale is the single device's.
* **Checkpoints and the CLI.** A (2, 2) run killed after its checkpoint
  and relaunched gives the uninterrupted losses; checkpoints cross
  between a mesh and one device both ways; ``--mesh single|multi
  --positions 4`` prints ``--mesh host``'s losses within the tolerance.
"""

import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed import sharding as jax_sharding
from repro.models import build_model as jax_build_model
from repro.models import init_from_template as jax_init
from repro.training import SyntheticLM as JaxSyntheticLM
from repro.training import make_batch as jax_make_batch
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import TRAIN_RULES
from repro_torch.ft.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, moe
from repro_torch.models.common import tree_flatten_with_names, tree_leaves, tree_map
from repro_torch.models.parallel import TrainShards, gather_train, place_train
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training.optimizer import adamw_update, global_norm
from repro_torch.training.train_loop import loss_and_grad

REPO = Path(__file__).resolve().parents[1]
FP32 = dict(dtype="float32", param_dtype="float32")
# tests/test_torch_training.py's tolerances, as they stand.
OPT_TOL, GRAD_TOL, LOSS_TOL, GNORM_TOL = 1e-6, 1e-4, 1e-4, 1e-3
ULP_MOVES, RESOLUTION_FACTOR = 3, 2.0
STEPS = 3
OPT_KW = dict(lr=3e-3, warmup_steps=2, total_steps=10)
FAMILIES = ["stablelm-1.6b", "granite-moe-1b-a400m", "falcon-mamba-7b", "hymba-1.5b",
            "seamless-m4t-large-v2", "paper-block"]
# Families whose every step-0 gradient leaf and loss the fp32 step resolves
# to GRAD_TOL / LOSS_TOL (tests/test_torch_training.py measures the others
# coarser: hymba, seamless and paper-block).
RESOLVED = ["stablelm-1.6b", "granite-moe-1b-a400m", "falcon-mamba-7b"]
PORT_MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
JAX_CASES = [(arch, (2, 2)) for arch in FAMILIES] + [("stablelm-1.6b", (2, 1, 2))]
METRICS = ("loss", "ce", "lb_loss", "grad_norm", "lr")


def _mesh(shape):
    return make_production_mesh(shape=shape, devices=["cpu"] * math.prod(shape))


def _model(arch):
    return build_model(dataclasses.replace(get_smoke_config(arch), **FP32))


@functools.lru_cache(maxsize=None)
def _numpy_weights(arch, move=0):
    """JAX's fp32 smoke weights (PRNGKey(0)) as numpy, as
    tests/test_torch_training.py draws them, each moved one ulp up or down
    with ``move`` (signs from that seed)."""
    jmodel = jax_build_model(dataclasses.replace(jax_smoke_config(arch), **FP32))
    tree = jax.tree.map(np.asarray, jax_init(jmodel.template, jax.random.PRNGKey(0), "float32"))
    if move:
        signs = np.random.default_rng(move)
        tree = jax.tree.map(lambda a: (a * (1 + 2.0**-23 * (signs.integers(0, 2, a.shape) * 2
                                                            - 1))).astype(np.float32), tree)
    return tree


@functools.lru_cache(maxsize=None)
def _numpy_batches(arch, B=4, S=16):
    """JAX's batches of steps 0 .. STEPS-1 as numpy."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), **FP32)
    data = JaxSyntheticLM(vocab_size=jcfg.vocab_size, seq_len=S, global_batch=B)
    return tuple(jax.tree.map(np.asarray, jax_make_batch(jcfg, data, s)) for s in range(STEPS))


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _state(model, tree, shape=None):
    params = params_from_numpy(tree, device="cpu")
    if shape is not None:
        params = place_train(model.cfg, model.template, params, _mesh(shape))
    return init_train_state(model, params)


def _logical(grads):
    return tree_leaves(gather_train(grads) if isinstance(grads, TrainShards) else grads)


@functools.lru_cache(maxsize=None)
def _port_run(arch, shape=None, move=0, B=4, S=16):
    """The port's 3 train steps from the numpy weights (moved ``move``):
    (metrics [STEPS, 5], step 0's logical gradient leaves)."""
    model = _model(arch)
    state = _state(model, _numpy_weights(arch, move), shape)
    batches = [_torch_batch(b) for b in _numpy_batches(arch, B, S)]
    (_, _), grads = loss_and_grad(model, state.params, batches[0])
    grads0 = [g.detach().clone() for g in _logical(grads)]
    step = make_train_step(model, AdamWConfig(**OPT_KW))
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append([float(m[k]) for k in METRICS])
    return np.array(metrics), grads0


def _leaf_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _hold_run(got, want, want_moved, grads, want_grads, grad_moves, what):
    """tests/test_torch_training.py's gates: each step's loss / ce /
    lb_loss within LOSS_TOL or RESOLUTION_FACTOR times the reference's own
    widest move, lr within OPT_TOL, grad_norm within GNORM_TOL wherever the
    reference resolves it, and at step 0 always (within RESOLUTION_FACTOR
    times its own move where that is wider); step 0's gradient leaf by
    leaf within GRAD_TOL of its scale or RESOLUTION_FACTOR times the
    reference's own widest move of that leaf."""
    for i in range(STEPS):
        own = np.abs(want_moved[:, i] - want[i]).max(axis=0) if len(want_moved) else \
            np.zeros(len(METRICS))
        for k in (0, 1, 2):
            tol = max(LOSS_TOL * abs(want[i, k]) + 1e-6, RESOLUTION_FACTOR * own[k])
            assert abs(got[i, k] - want[i, k]) <= tol, (what, i, METRICS[k], got[i, k],
                                                        want[i, k], tol)
        np.testing.assert_allclose(got[i, 4], want[i, 4], rtol=OPT_TOL, err_msg=what)
        move = own[3] / want[i, 3]
        if i == 0 or move <= GNORM_TOL:  # step 0 at the reference's own resolution
            np.testing.assert_allclose(got[i, 3], want[i, 3],
                                       rtol=max(GNORM_TOL, RESOLUTION_FACTOR * move),
                                       err_msg=f"{what} step {i}")
    assert len(grads) == len(want_grads)
    for j, (g, w) in enumerate(zip(grads, want_grads)):
        assert tuple(g.shape) == tuple(np.shape(w)), (what, j)
        err = _leaf_err(g, w)
        assert err <= max(GRAD_TOL, RESOLUTION_FACTOR * grad_moves[j]), (what, j, err,
                                                                         grad_moves[j])


def _port_moves(arch, B=4, S=16):
    """The port's own single-device widest moves under ULP_MOVES one-ulp
    weight moves: (metrics of the moved runs [moves, STEPS, 5], per-leaf
    widest move of step 0's gradient)."""
    base = _port_run(arch, None, 0, B, S)
    runs = [_port_run(arch, None, move, B, S) for move in range(1, ULP_MOVES + 1)]
    grad_moves = np.max([[_leaf_err(g, w) for g, w in zip(r[1], base[1])] for r in runs], axis=0)
    return np.stack([r[0] for r in runs]), grad_moves


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (2, 1, 2)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_shards_have_the_shapes_of_jaxs_train_shardings(arch, shape):
    model = _model(arch)
    params = tree_map(lambda s: torch.zeros(s.shape), model.template)
    ts = place_train(model.cfg, model.template, params, _mesh(shape))
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    jmesh = AbstractMesh(tuple(shape), axes)
    sizes = dict(zip(axes, shape))
    want = jax_sharding.param_shardings(jax_build_model(jax_smoke_config(arch)).template, jmesh,
                                        jax_sharding.TRAIN_RULES)
    want_specs = [tuple(s.spec) for s in jax.tree.leaves(
        want, is_leaf=lambda v: hasattr(v, "spec"))]
    names = ts.names()
    assert len(names) == len(want_specs)
    split = 0
    for i, ((shards, _), spec) in enumerate(zip(ts.leaf_shards(), want_specs)):
        full = tree_leaves(params)[i].shape
        spec = spec + (None,) * (len(full) - len(spec))
        shard = tuple(n // math.prod(sizes[a] for a in ((p,) if isinstance(p, str) else p or ()))
                      for n, p in zip(full, spec))
        assert all(tuple(t.shape) == shard for t in shards), (names[i], spec, shard)
        assert all(t.is_contiguous() for t in shards)
        split += shard != tuple(full)
    assert split > 0


# ---------------------------------------------------------------------------
# Against the port's single-device step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", PORT_MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_steps_match_the_single_device_port(arch, shape):
    got, grads = _port_run(arch, shape)
    want, want_grads = _port_run(arch, None)
    if arch in RESOLVED:
        moved, grad_moves = np.zeros((0, STEPS, len(METRICS))), np.zeros(len(want_grads))
        assert abs(got[0, 0] - want[0, 0]) <= LOSS_TOL * abs(want[0, 0])
    else:
        moved, grad_moves = _port_moves(arch)
    _hold_run(got, want, moved, grads, want_grads, grad_moves, (arch, shape))


@pytest.mark.parametrize("arch", FAMILIES)
def test_replicated_batch_and_sequence_match_the_single_device_port(arch):
    """B = 3, S = 15 on (2, 2): neither divides, so the batch and the
    residual's sequence are replicated, each row read once by the loss."""
    got, grads = _port_run(arch, (2, 2), B=3, S=15)
    want, want_grads = _port_run(arch, None, B=3, S=15)
    if arch in RESOLVED:
        moved, grad_moves = np.zeros((0, STEPS, len(METRICS))), np.zeros(len(want_grads))
    else:
        moved, grad_moves = _port_moves(arch, B=3, S=15)
    _hold_run(got, want, moved, grads, want_grads, grad_moves, (arch, "B=3 S=15"))


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------


def _mesh_state(arch, shape=(2, 2)):
    model = _model(arch)
    return model, _state(model, _numpy_weights(arch), shape)


def test_two_mesh_steps_from_one_state_are_bit_identical():
    for arch in ("granite-moe-1b-a400m", "hymba-1.5b"):
        model = _model(arch)
        batch = _torch_batch(_numpy_batches(arch)[0])
        runs = []
        for _ in range(2):
            state = _state(model, _numpy_weights(arch), (2, 2))
            state, m = make_train_step(model, AdamWConfig(**OPT_KW))(state, batch)
            runs.append(([float(m[k]) for k in METRICS], state.params.all_shards()))
        assert runs[0][0] == runs[1][0], arch
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])), arch


@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-moe-1b-a400m"])
def test_replicated_leaves_and_moments_stay_equal_on_every_position(arch):
    """After 3 steps every piece that several positions hold (norms,
    hymba's 5-head attention on every model position, granite-moe's router,
    any leaf over the data positions it is not split on) is bit-identical
    in the params and both moments."""
    model, state = _mesh_state(arch)
    step = make_train_step(model, AdamWConfig(**OPT_KW))
    for batch in _numpy_batches(arch):
        state, _ = step(state, _torch_batch(batch))
    copies = 0
    for tree in (state.params, state.opt["m"], state.opt["v"]):
        for shards, keys in tree.leaf_shards():
            first = {}
            for t, key in zip(shards, keys):
                if key in first:
                    assert torch.equal(t, first[key])
                    copies += 1
                else:
                    first[key] = t
    assert copies > 0


def test_moe_routing_on_the_mesh_is_the_single_devices():
    """granite-moe's routing on (2, 2) and (1, 4), at a capacity factor
    that drops assignments: the same experts, kept and dropped
    assignments and lb_loss as on one device."""
    arch = "granite-moe-1b-a400m"
    model = build_model(dataclasses.replace(_model(arch).cfg, capacity_factor=0.5))
    batch = _torch_batch(_numpy_batches(arch)[0])
    routed = []
    for shape in (None, (2, 2), (1, 4)):
        state = _state(model, _numpy_weights(arch), shape)
        moe.moe_ffn.routed, moe.moe_ffn.dropped = 0, 0
        keeps = []
        original = moe._route

        def recorded(*args, **kw):
            out = original(*args, **kw)
            keeps.append((out[3].clone(), out[6].clone()))  # expert_idx, keep
            return out

        moe._route = recorded
        try:
            (_, aux), _ = loss_and_grad(model, state.params, batch)
        finally:
            moe._route = original
        routed.append((moe.moe_ffn.routed, int(moe.moe_ffn.dropped), keeps,
                       float(aux["lb_loss"])))
    (r0, d0, k0, lb0), *rest = routed
    assert r0 == 2 * 4 * 16 * model.cfg.moe_top_k and d0 > 0
    for r, d, k, lb in rest:
        assert (r, d) == (r0, d0)
        assert all(torch.equal(a, b) and torch.equal(c, e) for (a, c), (b, e) in zip(k, k0))
        np.testing.assert_allclose(lb, lb0, rtol=1e-6)


def test_clip_scale_is_the_single_devices():
    """The global norm of shards is the logical gradient's (each piece
    once), so when it exceeds clip_norm the clip scale is the single
    device's: the first moments after one update, (1 - b1) times the
    clipped gradient, agree leaf by leaf within GRAD_TOL of their scale."""
    arch = "stablelm-1.6b"
    model = _model(arch)
    batch = _torch_batch(_numpy_batches(arch)[0])
    single = _state(model, _numpy_weights(arch))
    mesh = _state(model, _numpy_weights(arch), (2, 2))
    (_, _), g1 = loss_and_grad(model, single.params, batch)
    (_, _), g2 = loss_and_grad(model, mesh.params, batch)
    n1, n2 = float(global_norm(g1)), float(global_norm(g2))
    cfg = AdamWConfig(**OPT_KW)
    assert n1 > cfg.clip_norm
    np.testing.assert_allclose(n2, n1, rtol=1e-6)
    np.testing.assert_allclose(n2, float(global_norm(gather_train(g2))), rtol=1e-6)
    with torch.no_grad():
        _, o1, m1 = adamw_update(g1, single.opt, single.params, cfg)
        _, o2, m2 = adamw_update(g2, mesh.opt, mesh.params, cfg)
    assert float(m2["grad_norm"]) == n2
    for a, b in zip(tree_leaves(o1["m"]), tree_leaves(gather_train(o2["m"]))):
        assert _leaf_err(b, a) <= GRAD_TOL


# ---------------------------------------------------------------------------
# Checkpoints and the CLI
# ---------------------------------------------------------------------------


def test_checkpoints_cross_between_the_mesh_and_one_device(tmp_path):
    arch = "granite-moe-1b-a400m"
    model = _model(arch)
    batches = [_torch_batch(b) for b in _numpy_batches(arch)]
    step = make_train_step(model, AdamWConfig(**OPT_KW))
    for src, dst in (((2, 2), None), (None, (2, 2)), ((2, 2), (1, 4))):
        state = _state(model, _numpy_weights(arch), src)
        state, _ = step(state, batches[0])
        save_checkpoint(str(tmp_path / f"{src}-{dst}"), 1, state)
        names = [n for n, _ in tree_flatten_with_names(_state(model, _numpy_weights(arch)))]
        with open(next((tmp_path / f"{src}-{dst}").glob("step_*/manifest.json"))) as f:
            assert [e["name"] for e in json.load(f)["leaves"]] == names
        like = _state(model, _numpy_weights(arch), dst)
        restored, at = restore_checkpoint(str(tmp_path / f"{src}-{dst}"), like)
        assert at == 1 and isinstance(restored.params, TrainShards) == (dst is not None)
        _, want = step(state, batches[1])
        _, got = step(restored, batches[1])
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=LOSS_TOL)


def _run_cli(args, tmp_path, kill_at=None):
    """launch/train.py's main in a fresh process; with ``kill_at``, the
    process SIGKILLs itself right after that step's checkpoint lands."""
    code = ("import os, signal\n"
            "from repro_torch.launch import train as launcher\n"
            "save = launcher.save_checkpoint\n"
            "def save_then_die(directory, step, tree, **kw):\n"
            "    path = save(directory, step, tree, **kw)\n"
            f"    if step == {kill_at!r}:\n"
            "        os.kill(os.getpid(), signal.SIGKILL)\n"
            "    return path\n"
            "launcher.save_checkpoint = save_then_die\n"
            f"launcher.main({args!r})\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)


def _losses(stdout):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step\s+(\d+) loss=(\S+)", stdout, re.M)}


def test_cli_on_a_mesh_killed_and_relaunched_gives_the_uninterrupted_losses(tmp_path):
    base = ["--device", "cpu", "--smoke", "--steps", "6", "--ckpt-every", "3", "--seq", "16",
            "--mesh", "single", "--positions", "4"]
    whole = _run_cli(base + ["--ckpt-dir", str(tmp_path / "whole")], tmp_path)
    assert whole.returncode == 0, whole.stderr
    assert "mesh: {'data': 2, 'model': 2}" in whole.stdout
    killed = _run_cli(base + ["--ckpt-dir", str(tmp_path / "cut")], tmp_path, kill_at=3)
    assert killed.returncode == -9, killed.stderr
    relaunched = _run_cli(base + ["--ckpt-dir", str(tmp_path / "cut")], tmp_path)
    assert relaunched.returncode == 0, relaunched.stderr
    assert "restored checkpoint at step 3" in relaunched.stdout
    want, first, rest = _losses(whole.stdout), _losses(killed.stdout), _losses(relaunched.stdout)
    assert sorted(want) == [1, 2, 3, 4, 5, 6] and sorted(rest) == [4, 5, 6]
    assert {**first, **rest} == want


@pytest.mark.parametrize("mesh,shape", [("single", "{'data': 2, 'model': 2}"),
                                        ("multi", "{'pod': 2, 'data': 2, 'model': 1}")])
def test_cli_mesh_matches_the_host_mesh(mesh, shape, capsys):
    """``--mesh single|multi --positions 4 --device cpu --smoke`` against
    ``--mesh host``: the mesh from make_production_mesh's square-root rule
    and every loss within LOSS_TOL."""
    argv = ["--smoke", "--device", "cpu", "--steps", "4", "--seq", "16"]
    train_cli.main(argv)
    host = _losses(capsys.readouterr().out)
    train_cli.main(argv + ["--mesh", mesh, "--positions", "4"])
    out = capsys.readouterr().out
    assert f"mesh: {shape}" in out
    got = _losses(out)
    assert sorted(got) == sorted(host) == [1, 2, 3, 4]
    for s in host:
        assert abs(got[s] - host[s]) <= LOSS_TOL * abs(host[s]), (s, got[s], host[s])


def test_cli_refuses_positions_without_a_mesh():
    with pytest.raises(SystemExit):
        train_cli.main(["--smoke", "--device", "cpu", "--positions", "4"])


# ---------------------------------------------------------------------------
# Against JAX's mesh step
# ---------------------------------------------------------------------------

JAX_MESH_STEP = """
import os, sys, json
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import dataclasses
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.distributed.sharding import TRAIN_RULES, divisible_spec, param_shardings, use_mesh_rules
from repro.models import build_model
from repro.training import AdamWConfig, adamw_update, init_train_state
from repro.training.train_loop import MOE_AUX_WEIGHT, TrainState, cross_entropy

BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "frames": ("batch", "act_seq", "frontend")}
out_dir, cases, opt_kw = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
for arch, shape, steps, moves in cases:
    src = np.load(os.path.join(out_dir, f"{arch}.npz"))
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)
    treedef = jax.tree.structure(model.template, is_leaf=lambda x: hasattr(x, "axes"))
    base = [src[f"leaf_{i}"] for i in range(treedef.num_leaves)]
    batches = [{k.split("_", 1)[1]: src[k] for k in src.files if k.startswith(f"b{s}_")}
               for s in range(steps)]
    opt_cfg = AdamWConfig(**opt_kw)

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        ce = cross_entropy(logits, batch["labels"])
        loss = ce + MOE_AUX_WEIGHT * aux["lb_loss"] if cfg.is_moe else ce
        return loss, {"ce": ce, "lb_loss": aux["lb_loss"]}

    def train_step(state, batch):  # make_train_step's, its gradient returned beside it
        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params, batch)
        params, opt, opt_metrics = adamw_update(grads, state.opt, state.params, opt_cfg)
        return (TrainState(params=params, opt=opt, step=state.step + 1),
                {"loss": loss, **metrics, **opt_metrics}, grads)

    with use_mesh_rules(mesh, TRAIN_RULES):  # dryrun.py's layout of the train state
        p_sh = param_shardings(model.template, mesh, TRAIN_RULES)
        rep = NamedSharding(mesh, P())
        state_sh = TrainState(params=p_sh, opt={"m": p_sh, "v": p_sh, "count": rep}, step=rep)
        b_sh = {k: NamedSharding(mesh, P(*divisible_spec(v.shape, BATCH_AXES[k], mesh,
                                                         TRAIN_RULES)))
                for k, v in batches[0].items()}
        step = jax.jit(train_step, in_shardings=(state_sh, b_sh),
                       out_shardings=(state_sh, None, p_sh))
        runs = []
        for move in range(moves + 1):
            leaves = base
            if move:
                rng = np.random.default_rng(move)
                leaves = [(a * (1 + 2.0**-23 * (rng.integers(0, 2, a.shape) * 2 - 1)))
                          .astype(np.float32) for a in base]
            state = init_train_state(model, jax.device_put(jax.tree.unflatten(treedef, leaves),
                                                           p_sh))
            metrics, grads0 = [], None
            for s in range(steps):
                state, m, g = step(state, jax.device_put(batches[s], b_sh))
                metrics.append([float(m[k]) for k in
                                ("loss", "ce", "lb_loss", "grad_norm", "lr")])
                grads0 = grads0 if s else [np.asarray(x) for x in jax.tree.leaves(g)]
            runs.append((np.array(metrics), grads0))
    base_g = runs[0][1]
    gmove = np.zeros(len(base_g))
    for _, g in runs[1:]:
        gmove = np.maximum(gmove, [float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                                    1e-30)
                                   for a, b in zip(g, base_g)])
    np.savez(os.path.join(out_dir, f"jax_{arch}_{'x'.join(map(str, shape))}.npz"),
             metrics=np.stack([r[0] for r in runs]), grad_moves=gmove,
             **{f"grad_{i}": a for i, a in enumerate(base_g)})
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke steps are small: one intra-op thread each runs them faster
    than a pool contended by the JAX subprocesses."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """JAX's mesh runs of JAX_CASES, computed once in two subprocesses
    started with the module's first test, so that they run beside the
    port's tests; the returned function waits for a case's file."""
    out = tmp_path_factory.mktemp("jax_mesh")
    for arch in FAMILIES:
        arrays = {f"leaf_{i}": a for i, a in enumerate(tree_leaves(_numpy_weights(arch)))}
        for s, batch in enumerate(_numpy_batches(arch)):
            arrays.update({f"b{s}_{k}": v for k, v in batch.items()})
        np.savez(out / f"{arch}.npz", **arrays)
    halves = [[c for c in JAX_CASES if c[0] in ("hymba-1.5b", "stablelm-1.6b")],
              [c for c in JAX_CASES if c[0] not in ("hymba-1.5b", "stablelm-1.6b")]]
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_MESH_STEP, str(out),
         json.dumps([[arch, list(shape), STEPS, ULP_MOVES] for arch, shape in half]),
         json.dumps(OPT_KW)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
        for half in halves]

    def result(arch, shape):
        for proc in procs:
            if proc.returncode is None:
                _, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-3000:]
        return np.load(out / f"jax_{arch}_{'x'.join(map(str, shape))}.npz")

    yield result
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("arch,shape", JAX_CASES,
                         ids=[f"{a}-{'x'.join(map(str, s))}" for a, s in JAX_CASES])
def test_mesh_steps_match_jaxs_train_rules_step(arch, shape, jax_runs):
    ref = jax_runs(arch, shape)
    got, grads = _port_run(arch, shape)
    runs = ref["metrics"]
    want_grads = [ref[f"grad_{i}"] for i in range(len(grads))]
    _hold_run(got, runs[0], runs[1:], grads, want_grads, ref["grad_moves"], (arch, shape))
