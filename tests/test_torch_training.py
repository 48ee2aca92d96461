"""The port's training path against the JAX package's, on the CPU, fp32,
on weights carried across by ``params_from_numpy`` and JAX's batches fed
to both packages as numpy.

* AdamW (``adamw_update`` over 5 steps, ``lr_schedule``, ``global_norm``)
  and ``cross_entropy`` against JAX's within 1e-6, and JAX's own
  ``TestOptimizer`` / ``TestLoss`` cases on the port.
* ``forward`` (logits and ``lb_loss``) against JAX's ``forward`` for the
  stablelm, granite-moe, falcon-mamba, hymba and internvl2 (with patch
  embeddings) smoke configs within 1e-5 of scale, and ``encdec.forward``
  for seamless and paper-block (frames and tokens) within 1e-4.
* The train loss's gradient (``loss_and_grad``) against ``jax.grad`` for
  the smoke configs of every family that trains, every leaf within 1e-4
  of its own scale; 5 ``make_train_step`` steps with losses within 1e-4
  relative. A leaf or a step's value that JAX itself resolves only
  coarser (a one-ulp move of JAX's weights moves it by more: hymba,
  seamless and paper-block) is held at JAX's own resolution, measured in
  the test for that value.
  At 24 layers the gradient grows toward the input in both packages alike
  (each layer's norm within a factor 4 of JAX's).
* Remat on, off and in blocks: equal losses and gradients; the MoE
  counters count each layer's forward once under remat.
* ``flash_attention_bwd_ref`` (the backward kernel's plain version)
  against autograd through ``attention_ref`` and against ``jax.vjp`` of
  JAX's attention oracle, with GQA, windows and Sq != Skv, at head_dim 8
  and 16 too. The scan's backward has its own file
  (``test_torch_scan_bwd.py``).
* The gradient guard of the kernels without a backward, the synthetic
  data, and ``launch/train.py --device cpu --smoke``: a run killed after
  its step-3 checkpoint and relaunched gives the uninterrupted run's
  losses exactly; an encoder-decoder trains through the CLI, and so does
  a mesh of two CPU positions (``--mesh single --positions 2``).
"""

import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import build_model as jax_build_model
from repro.models import init_from_template as jax_init
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import SyntheticLM as JaxSyntheticLM
from repro.training import adamw_init as jax_adamw_init
from repro.training import adamw_update as jax_adamw_update
from repro.training import cross_entropy as jax_cross_entropy
from repro.training import init_train_state as jax_init_train_state
from repro.training import lr_schedule as jax_lr_schedule
from repro.training import make_batch as jax_make_batch
from repro.training import make_train_step as jax_make_train_step
from repro.training.optimizer import global_norm as jax_global_norm
from repro.training.train_loop import MOE_AUX_WEIGHT as JAX_MOE_AUX_WEIGHT
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    decode_attention,
    paged_decode_attention,
    paged_prefill_attention,
)
from repro_torch.kernels.flash_attention import (
    attention_lse_ref,
    attention_ref,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_ref,
)
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, moe
from repro_torch.models.common import tree_leaves
from repro_torch.training import (
    AdamWConfig,
    SyntheticLM,
    adamw_init,
    adamw_update,
    cross_entropy,
    init_train_state,
    lr_schedule,
    make_batch,
    make_train_step,
)
from repro_torch.training.optimizer import global_norm
from repro_torch.training.train_loop import MOE_AUX_WEIGHT, loss_and_grad

REPO = Path(__file__).resolve().parents[1]
FP32 = dict(dtype="float32", param_dtype="float32")
OPT_TOL = 1e-6
FWD_TOL = 1e-5  # of scale: two layers of fp32 matmuls summed in another order
GRAD_TOL = 1e-4  # of each leaf's scale: the backward adds a second such chain
# The encoder-decoders' logits, of scale, as tests/test_torch_encdec.py holds
# their prefill: the two packages part by up to 3e-5 of scale in fp32.
ENCDEC_TOL = 1e-4
LOSS_TOL = 1e-4  # relative, over 5 steps
GNORM_TOL = 1e-3  # relative: the norm sums the squares of every leaf's drift
DEPTH_GROWTH = 1e3  # layer 0's gradient norm over the last layer's, at 24 layers
DEPTH_SPREAD = 4.0  # each layer's gradient norm against JAX's at 24 layers, a factor


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, what=""):
    """Within ``tol`` of the reference's largest magnitude (at least 1)."""
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0, err_msg=what)


def _pair(arch, **over):
    """The fp32 smoke model of ``arch`` in both packages on JAX's weights."""
    jmodel = jax_build_model(dataclasses.replace(jax_smoke_config(arch), **FP32, **over))
    tree = jax.tree.map(np.asarray, jax_init(jmodel.template, jax.random.PRNGKey(0), "float32"))
    tmodel = build_model(dataclasses.replace(get_smoke_config(arch), **FP32, **over))
    return jmodel, jax.tree.map(jnp.asarray, tree), tmodel, params_from_numpy(tree, device="cpu")


def _jax_batch(jmodel, step, B=2, S=16):
    """JAX's batch (tokens, labels and modality extras) as numpy."""
    data = JaxSyntheticLM(vocab_size=jmodel.cfg.vocab_size, seq_len=S, global_batch=B)
    return jax.tree.map(np.asarray, jax_make_batch(jmodel.cfg, data, step))


def _torch_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Optimizer and loss
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "nested": {"b": rng.standard_normal(5).astype(np.float32),
                       "a": rng.standard_normal((2, 2, 2)).astype(np.float32)}}


def test_adamw_update_matches_jax_over_5_steps():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1, clip_norm=1.5)
    jcfg, tcfg = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    jp, jopt = jax.tree.map(jnp.asarray, params), jax_adamw_init(jax.tree.map(jnp.asarray, params))
    tp = jax.tree.map(_t, params)
    topt = adamw_init(tp)
    for step in range(5):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.7,
                             params)
        jp, jopt, jm = jax_adamw_update(jax.tree.map(jnp.asarray, grads), jopt, jp, jcfg)
        tp, topt, tm = adamw_update(jax.tree.map(_t, grads), topt, tp, tcfg)
        assert int(topt["count"]) == int(jopt["count"]) == step + 1
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=OPT_TOL)
        for got, want in zip(tree_leaves(tp) + tree_leaves(topt["m"]) + tree_leaves(topt["v"]),
                             jax.tree.leaves(jp) + jax.tree.leaves(jopt["m"])
                             + jax.tree.leaves(jopt["v"])):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=OPT_TOL, atol=OPT_TOL)


def test_adamw_moments_are_fp32_beside_bf16_params():
    params = {"w": torch.ones(3, dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt["m"]["w"].dtype == opt["v"]["w"].dtype == torch.float32
    assert opt["count"].dtype == torch.int32
    params, _, _ = adamw_update({"w": torch.ones(3, dtype=torch.bfloat16)}, opt, params,
                                AdamWConfig(warmup_steps=0))
    assert params["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100])
def test_lr_schedule_matches_jax(step):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = float(lr_schedule(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32)))
    want = float(jax_lr_schedule(JaxAdamWConfig(**kw), jnp.int32(step)))
    np.testing.assert_allclose(got, want, rtol=OPT_TOL, atol=OPT_TOL)


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(1))
    np.testing.assert_allclose(float(global_norm(jax.tree.map(_t, tree))),
                               float(jax_global_norm(jax.tree.map(jnp.asarray, tree))),
                               rtol=OPT_TOL)


# JAX's TestOptimizer and TestLoss (tests/test_training.py), on the port.

def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(grads, opt, params, cfg)
    assert float(torch.sum(torch.square(params["w"]))) < 0.3


def test_weight_decay_shrinks():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=1.0)
    params = {"w": torch.tensor([5.0])}
    params2, _, _ = adamw_update({"w": torch.tensor([0.0])}, adamw_init(params), params, cfg)
    assert float(params2["w"][0]) < 5.0


def test_clipping_reports_the_norm_before_the_clip():
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    _, _, m = adamw_update({"w": torch.full((4,), 100.0)}, adamw_init(params), params, cfg)
    assert float(m["grad_norm"]) > 100


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(float(cross_entropy(_t(logits), _t(labels))),
                               float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=OPT_TOL)


def test_cross_entropy_perfect_prediction():
    logits = torch.full((1, 3, 5), -20.0)
    labels = torch.tensor([[1, 2, 3]])
    logits[0, torch.arange(3), labels[0]] = 20.0
    assert float(cross_entropy(logits, labels)) < 1e-3


def test_cross_entropy_uniform():
    V = 7
    loss = cross_entropy(torch.zeros(2, 4, V), torch.zeros(2, 4, dtype=torch.int32))
    assert float(loss) == pytest.approx(np.log(V), rel=1e-5)


def test_moe_aux_weight_is_jax_s():
    assert MOE_AUX_WEIGHT == JAX_MOE_AUX_WEIGHT


# ---------------------------------------------------------------------------
# forward, gradients, train steps
# ---------------------------------------------------------------------------

FORWARD_ARCHS = ["stablelm-1.6b", "granite-moe-1b-a400m", "falcon-mamba-7b", "hymba-1.5b",
                 "internvl2-76b"]


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_matches_jax(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    batch = _jax_batch(jmodel, 3)
    if arch == "internvl2-76b":
        assert batch["patch_embeds"].shape[1] > 0
    want, jaux = jmodel.forward(jparams, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got, taux = tmodel.forward(tparams, _torch_batch(batch))
    assert tuple(got.shape) == want.shape
    _close(got, want, FWD_TOL, arch)
    np.testing.assert_allclose(float(taux["lb_loss"]), float(jaux["lb_loss"]), atol=FWD_TOL)
    if arch == "granite-moe-1b-a400m":
        assert float(taux["lb_loss"]) > 0


def _jax_loss_and_grad(jmodel, jparams, batch):
    def loss_fn(params):
        logits, aux = jmodel.forward(params, batch)
        loss = jax_cross_entropy(logits, batch["labels"])
        if jmodel.cfg.is_moe:
            loss = loss + JAX_MOE_AUX_WEIGHT * aux["lb_loss"]
        return loss

    return jax.value_and_grad(loss_fn)(jparams)


# The smoke configs of every family that trains. JAX resolves the fp32
# gradient of some of them only coarser than GRAD_TOL: a one-ulp move of
# JAX's own weights moves a leaf of its step-0 gradient by up to 4.8e-4
# (hymba), 9.7e-4 (seamless) and 6.0e-4 (paper-block) of the leaf's scale
# (stablelm 2.5e-5, granite-moe 4.4e-5, falcon-mamba 1.9e-6; the widest of
# ULP_MOVES moves), and five
# AdamW steps from the moved weights part from the unmoved ones' run by up
# to 0.4%, 4.7% and 1.8% in loss and 19%, 50% and 53% in grad norm: AdamW's
# first update moves every element by about lr whatever its gradient's size,
# so an element whose gradient lies below the rounding takes either sign.
# A value that JAX itself does not resolve to its tolerance is held to
# RESOLUTION_FACTOR times JAX's own widest move over ULP_MOVES such moves,
# measured in the test for that value alone.
TRAIN_ARCHS = ["stablelm-1.6b", "granite-moe-1b-a400m", "falcon-mamba-7b", "hymba-1.5b",
               "seamless-m4t-large-v2", "paper-block"]
ULP_MOVES = 3  # one-ulp moves of JAX's weights that measure its resolution
RESOLUTION_FACTOR = 2.0  # the port against JAX, over JAX against its widest move


def _ulp_moved(jparams, seed):
    """JAX's weights, each moved one fp32 ulp up or down (signs from seed)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a) * (
        1 + 2.0**-23 * (rng.integers(0, 2, a.shape) * 2 - 1)).astype(np.float32)), jparams)


def _leaf_err(got, want) -> float:
    """A leaf's largest error relative to that leaf's scale."""
    want = np.asarray(want)
    return float(np.abs(_np(got) - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_gradients_match_jax(arch):
    """The train loss within LOSS_TOL of JAX's, and every leaf of its
    gradient within GRAD_TOL of the leaf's scale, or, for a leaf past
    GRAD_TOL, within RESOLUTION_FACTOR times the widest move of JAX's own
    gradient of that leaf under ULP_MOVES one-ulp moves of JAX's weights.
    Measured: no leaf of stablelm, granite-moe or falcon-mamba past
    GRAD_TOL; hymba's 27 of 53, seamless's 24 of 25 and paper-block's 8 of
    26 leaves past it, each at 0.29-1.15 of its own widest move."""
    jmodel, jparams, tmodel, tparams = _pair(arch)
    batch = _jax_batch(jmodel, 0)
    jbatch = jax.tree.map(jnp.asarray, batch)
    value_and_grad = jax.jit(lambda p: _jax_loss_and_grad(jmodel, p, jbatch))
    jloss, jgrads = value_and_grad(jparams)
    (tloss, _), tgrads = loss_and_grad(tmodel, tparams, _torch_batch(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_TOL)
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    want, got = jax.tree.leaves(jgrads), tree_leaves(tgrads)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    errs = [_leaf_err(g, w) for g, w in zip(got, want)]
    past = [i for i, e in enumerate(errs) if e > GRAD_TOL]
    if not past:
        return
    moves = np.zeros(len(want))
    for seed in range(1, ULP_MOVES + 1):
        moved = jax.tree.leaves(value_and_grad(_ulp_moved(jparams, seed))[1])
        moves = np.maximum(moves, [_leaf_err(m, w) for m, w in zip(moved, want)])
    for i in past:
        assert errs[i] <= RESOLUTION_FACTOR * moves[i], (names[i], errs[i], moves[i])


def _depth_gradients():
    """``scripts/torch_depth_gradients.py``, whose ``measure`` the test holds."""
    spec = importlib.util.spec_from_file_location(
        "torch_depth_gradients", REPO / "scripts" / "torch_depth_gradients.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-moe-1b-a400m"])
def test_gradient_explodes_toward_the_input_as_in_jax(arch):
    """At the trained models' depth (24 layers, smoke widths) the JAX
    init's random model has a gradient that grows toward the input: layer
    0's norm is 4.1e4 / 6.7e4 times the last layer's in the JAX package.
    The port's grows the same way. There the backward is so
    ill-conditioned that a one-ulp change of JAX's own weights moves JAX's
    norm by up to 2.2 times, so each layer's norm is held to a factor
    DEPTH_SPREAD of JAX's (measured: within 1.16 / 1.26;
    ``scripts/torch_depth_gradients.py`` prints all of these)."""
    row = _depth_gradients().measure(arch, n_layers=24, step=0, spread=False)
    assert row["jax_layer0_over_last"] >= DEPTH_GROWTH, row
    assert row["port_layer0_over_last"] >= DEPTH_GROWTH, row
    assert row["worst_layer_ratio"] <= DEPTH_SPREAD, row


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_match_jax(arch):
    """5 ``make_train_step`` steps, each package from its own state. Each
    step's lr within OPT_TOL of JAX's; its loss, ce and lb_loss within
    LOSS_TOL, or within RESOLUTION_FACTOR times the widest move of JAX's
    own value when JAX runs from its weights moved one ulp (ULP_MOVES
    runs), where that is wider; its grad_norm likewise wherever JAX
    resolves it (JAX's own widest move within GNORM_TOL), which every
    config does at step 0 (seamless: JAX's move 7.8e-4). Measured: stablelm,
    granite-moe and falcon-mamba resolve every step (JAX's moves at most
    1.8e-6 in loss, 4.1e-4 in grad_norm); hymba, seamless and paper-block
    part from JAX by up to 2.8e-3, 1.0e-2 and 7.7e-3 in loss by step 4,
    where JAX's own runs part by up to 3.9e-3, 4.7e-2 and 1.8e-2, and
    resolve the grad_norm at step 0 only."""
    jmodel, jparams, tmodel, tparams = _pair(arch)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jmodel, JaxAdamWConfig(**kw)))
    jstate = jax_init_train_state(jmodel, jparams)
    jmoved = [jax_init_train_state(jmodel, _ulp_moved(jparams, seed))
              for seed in range(1, ULP_MOVES + 1)]
    tstate = init_train_state(tmodel, tparams)
    tstep = make_train_step(tmodel, AdamWConfig(**kw))
    for i in range(5):
        batch = _jax_batch(jmodel, i, B=4, S=32)
        jbatch = jax.tree.map(jnp.asarray, batch)
        jstate, jm = jstep(jstate, jbatch)
        moved = [jstep(state, jbatch) for state in jmoved]
        jmoved = [state for state, _ in moved]
        tstate, tm = tstep(tstate, _torch_batch(batch))

        def own_move(name):
            return max(abs(float(m[name]) - float(jm[name])) for _, m in moved)

        for name in ("loss", "ce", "lb_loss"):
            tol = max(LOSS_TOL * abs(float(jm[name])) + 1e-6, RESOLUTION_FACTOR * own_move(name))
            assert abs(float(tm[name]) - float(jm[name])) <= tol, (i, name, float(tm[name]),
                                                                   float(jm[name]), tol)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=OPT_TOL)
        norm = float(jm["grad_norm"])
        move = own_move("grad_norm") / norm
        assert move <= GNORM_TOL or i > 0, (i, move)
        if move <= GNORM_TOL:
            # The global norm of a gradient taken after i AdamW steps on
            # each side; the step-0 gradient is held leaf by leaf above.
            np.testing.assert_allclose(float(tm["grad_norm"]), norm,
                                       rtol=max(GNORM_TOL, RESOLUTION_FACTOR * move),
                                       err_msg=f"step {i}")
    assert int(tstate.step) == int(jstate.step) == 5


def _remat_grads(arch, **over):
    jmodel, _, tmodel, tparams = _pair(arch, n_layers=4, **over)
    batch = _torch_batch(_jax_batch(jmodel, 1))
    moe.moe_ffn.routed, moe.moe_ffn.dropped = 0, 0
    (loss, _), grads = loss_and_grad(tmodel, tparams, batch)
    return loss, tree_leaves(grads), moe.moe_ffn.routed


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_remat_changes_nothing(arch):
    loss, grads, routed = _remat_grads(arch, remat=False)
    cfg = get_smoke_config(arch)
    assert routed == (4 * 2 * 16 * cfg.moe_top_k if cfg.is_moe else 0)
    for over in (dict(remat=True), dict(remat=True, remat_block=2)):
        loss2, grads2, routed2 = _remat_grads(arch, **over)
        assert routed2 == routed, over  # the recompute is not counted
        assert float(loss2) == float(loss)
        for a, b in zip(grads, grads2):
            assert torch.equal(a, b), over


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "paper-block"])
def test_encdec_forward_matches_jax(arch):
    """``encdec.forward`` (teacher forcing: JAX's frames through the
    encoder, the tokens through the decoder) gives JAX's logits within
    ENCDEC_TOL of scale and an lb_loss of 0, with remat on and off alike,
    and its last position equals the port's own prefill; the gradients are
    held in ``test_gradients_match_jax``."""
    jmodel, jparams, tmodel, tparams = _pair(arch)
    batch = _jax_batch(jmodel, 2)
    assert batch["frames"].shape == (2, 16, jmodel.cfg.frontend_dim)
    want, _ = jmodel.forward(jparams, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got, taux = tmodel.forward(tparams, _torch_batch(batch))
        plain, _ = build_model(dataclasses.replace(tmodel.cfg, remat=False)).forward(
            tparams, _torch_batch(batch))
    assert tuple(got.shape) == want.shape == (2, 16, jmodel.cfg.vocab_size)
    _close(got, want, ENCDEC_TOL, arch)
    assert torch.equal(got, plain)
    with torch.no_grad():
        last, _ = tmodel.prefill(tparams, _torch_batch(batch), 16)
    _close(got[:, -1:], last, FWD_TOL, f"{arch} forward's last position vs prefill")
    assert float(taux["lb_loss"]) == 0.0


# ---------------------------------------------------------------------------
# The backward kernel's plain version
# ---------------------------------------------------------------------------

BWD_CASES = [
    # B, Sq, Skv, H, KV, D, causal, window
    (2, 33, 33, 4, 4, 16, True, None),  # causal, ragged
    (1, 40, 40, 4, 2, 16, True, 9),  # windowed, GQA G=2
    (2, 24, 24, 8, 2, 8, True, None),  # GQA G=4
    (2, 7, 19, 4, 2, 16, False, None),  # bidirectional, Sq != Skv
    # paper-block's head_dim 8 (100 heads, KV = H): its encoder, decoder and
    # cross-attention; the encoder-decoder smoke configs' head_dim 16.
    (2, 21, 21, 10, 10, 8, False, None),  # bidirectional encoder
    (2, 21, 21, 10, 10, 8, True, None),  # causal decoder
    (2, 13, 29, 10, 10, 8, False, None),  # cross, Sq != Skv
    (2, 16, 16, 4, 4, 16, False, None),  # seamless-smoke's encoder
    (2, 16, 11, 4, 4, 16, False, None),  # cross, Sq > Skv
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window", BWD_CASES)
def test_flash_bwd_ref_matches_autograd_and_jax_vjp(B, Sq, Skv, H, KV, D, causal, window):
    rng = np.random.default_rng(B * 100 + Sq)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_fwd(_t(q), _t(k), _t(v), **kw)
    got = flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(do), **kw)
    # flash_attention_bwd on CPU tensors is the plain version.
    for a, b in zip(got, flash_attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(do), **kw)):
        assert torch.equal(a, b)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = attention_ref(*(t.transpose(1, 2) for t in leaves), **kw).transpose(1, 2)
    auto = torch.autograd.grad(out, leaves, _t(do))
    bhsd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, **kw), bhsd(q), bhsd(k), bhsd(v))
    jgrads = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(bhsd(do))]
    for name, g, a, j in zip(("dq", "dk", "dv"), got, auto, jgrads):
        assert g.shape == a.shape == j.shape, name
        _close(g, a, FWD_TOL, name)
        _close(g, j, FWD_TOL, name)


def test_lse_ref_is_the_softmax_normalizer():
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((1, 9, 4, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 9, 2, 16)).astype(np.float32))
    v = _t(rng.standard_normal((1, 9, 2, 16)).astype(np.float32))
    lse = attention_lse_ref(q, k, causal=True, window=4)
    # Row 0 sees key 0 alone: lse = its scaled score.
    want = (q[0, 0] * k[0, 0].repeat_interleave(2, 0)).sum(-1) * 16**-0.5
    torch.testing.assert_close(lse[0, :, 0], want)
    o, lse2 = flash_attention_fwd(q, k, v, causal=True, window=4)
    assert torch.equal(lse, lse2)
    assert torch.equal(o, flash_attention_ref(q, k, v, causal=True, window=4))


def test_flash_attention_on_cpu_is_differentiable():
    rng = np.random.default_rng(6)
    q, k, v = (_t(rng.standard_normal((1, 8, 2, 16)).astype(np.float32)).requires_grad_()
               for _ in range(3))
    before = flash_attention.launches
    flash_attention(q, k, v).sum().backward()
    assert flash_attention.launches == before
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in (q, k, v))


# ---------------------------------------------------------------------------
# The gradient guard of the kernels without a backward
# ---------------------------------------------------------------------------

def test_refuse_grad_raises_only_when_a_gradient_would_be_cut():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="decode_attention: the CUDA kernel has no backward"):
        _build.refuse_grad("decode_attention", torch.ones(3), x, None)
    with torch.no_grad():
        _build.refuse_grad("decode_attention", x)
    _build.refuse_grad("rmsnorm", torch.ones(3), None)


def test_wrappers_refuse_grad_before_they_launch(monkeypatch):
    """Each kernel wrapper without a backward checks for grad on its CUDA
    path, before anything reaches the device: a tensor that claims to be
    on CUDA takes that path here. The scan and flash wrappers, whose
    kernels have a backward, do not call the guard."""
    calls = []
    monkeypatch.setattr(_build, "refuse_grad", lambda name, *t: calls.append(name)
                        or (_ for _ in ()).throw(RuntimeError(name)))

    class Fake(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    x = torch.ones(1, 4, 8).as_subclass(Fake)
    wrappers = {
        "rmsnorm": (rmsnorm, (x, x)),
        "decode_attention": (decode_attention, (x, x, x, x)),
        "paged_decode_attention": (paged_decode_attention, (x, x, x, x, x)),
        "paged_prefill_attention": (paged_prefill_attention, (x, x, x, x, x)),
    }
    for fn, args in wrappers.values():
        with pytest.raises(RuntimeError):
            fn(*args)
    assert calls == list(wrappers)
    for fn, args in ((selective_scan, (x, x, x, x, x)), (flash_attention, (x, x, x))):
        with pytest.raises(ValueError):  # the shape checks, past any guard
            fn(*args)
    assert calls == list(wrappers)


# ---------------------------------------------------------------------------
# Data and the launcher
# ---------------------------------------------------------------------------

def test_synthetic_batches_are_a_function_of_seed_and_step():
    data = SyntheticLM(vocab_size=50, seq_len=12, global_batch=3, seed=4)
    a, b = data.batch(7), data.batch(7)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], data.batch(8)["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].max()) < 50 and tuple(a["tokens"].shape) == (3, 12)


@pytest.mark.parametrize("arch,key,shape", [
    ("internvl2-76b", "patch_embeds", (2, 4, 48)),
    ("seamless-m4t-large-v2", "frames", None),
])
def test_make_batch_adds_the_modality_stubs_as_jax(arch, key, shape):
    cfg = dataclasses.replace(get_smoke_config(arch), **FP32)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    got = make_batch(cfg, data, 3, device="cpu")
    jcfg = dataclasses.replace(jax_smoke_config(arch), **FP32)
    want = jax_make_batch(jcfg, JaxSyntheticLM(jcfg.vocab_size, 16, 2), 3)
    assert sorted(got) == sorted(want)
    assert tuple(got[key].shape) == want[key].shape == (shape or want[key].shape)
    assert got[key].dtype == torch.float32


def _run_cli(args, tmp_path, kill_at=None):
    """launch/train.py's main in a fresh process; with ``kill_at``, the
    process SIGKILLs itself right after that step's checkpoint lands."""
    code = ("import os, signal, sys\n"
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


def test_cli_killed_and_relaunched_gives_the_uninterrupted_losses(tmp_path):
    base = ["--device", "cpu", "--smoke", "--steps", "6", "--ckpt-every", "3", "--seq", "32"]
    whole = _run_cli(base + ["--ckpt-dir", str(tmp_path / "whole")], tmp_path)
    assert whole.returncode == 0, whole.stderr
    killed = _run_cli(base + ["--ckpt-dir", str(tmp_path / "cut")], tmp_path, kill_at=3)
    assert killed.returncode == -9, killed.stderr
    relaunched = _run_cli(base + ["--ckpt-dir", str(tmp_path / "cut")], tmp_path)
    assert relaunched.returncode == 0, relaunched.stderr
    assert "restored checkpoint at step 3" in relaunched.stdout
    want, first, rest = _losses(whole.stdout), _losses(killed.stdout), _losses(relaunched.stdout)
    assert sorted(want) == [1, 2, 3, 4, 5, 6] and sorted(first) == [1, 2, 3]
    assert sorted(rest) == [4, 5, 6]
    assert {**first, **rest} == want


def test_cli_trains_on_a_mesh(capsys):
    """``--mesh single --positions 2 --device cpu --smoke``: a (data 2,
    model 1) mesh of two CPU positions (the square-root rule), a finite
    loss every step
    (tests/test_torch_train_mesh.py holds the mesh's steps to the single
    device's and to JAX's); ``--positions`` without a mesh is refused."""
    train_cli.main(["--smoke", "--device", "cpu", "--mesh", "single", "--positions", "2",
                    "--steps", "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "mesh: {'data': 2, 'model': 1} over ['cpu', 'cpu']" in out
    losses = _losses(out)
    assert sorted(losses) == [1, 2, 3] and all(np.isfinite(list(losses.values())))
    with pytest.raises(SystemExit):
        train_cli.main(["--smoke", "--device", "cpu", "--positions", "2"])
    assert "--positions needs --mesh" in capsys.readouterr().err


def test_cli_trains_an_encoder_decoder_on_the_cpu(capsys):
    """``--arch seamless-m4t-large-v2 --smoke --device cpu``: batches with
    frames through ``encdec.forward``, a finite loss every step."""
    train_cli.main(["--smoke", "--device", "cpu", "--arch", "seamless-m4t-large-v2",
                    "--steps", "3", "--batch", "2", "--seq", "16"])
    losses = _losses(capsys.readouterr().out)
    assert sorted(losses) == [1, 2, 3] and all(np.isfinite(list(losses.values())))


def test_cli_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--smoke", "--steps", "1"])
