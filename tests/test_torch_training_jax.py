"""The port's training path against the JAX package's, on the CPU, fp32:
the forward, the train loss's gradient and whole train steps, on weights
carried across by ``params_from_numpy`` and JAX's batches fed to both
packages as numpy (the helpers and tolerances of
``tests/test_torch_training.py``, which holds the optimizer, the loss,
depth, remat, the flash backward's plain version and the CLI).

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
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import cross_entropy as jax_cross_entropy
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step
from repro.training.train_loop import MOE_AUX_WEIGHT as JAX_MOE_AUX_WEIGHT
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training.train_loop import loss_and_grad
from test_torch_training import (  # the shared helpers and tolerances
    ENCDEC_TOL,
    FWD_TOL,
    GNORM_TOL,
    GRAD_TOL,
    LOSS_TOL,
    OPT_TOL,
    TRAIN_ARCHS,
    _close,
    _jax_batch,
    _np,
    _pair,
    _torch_batch,
)

# JAX resolves the fp32 gradient of some smoke configs only coarser than
# GRAD_TOL: a one-ulp move of JAX's own weights moves a leaf of its step-0
# gradient by up to 4.8e-4 (hymba), 9.7e-4 (seamless) and 6.0e-4
# (paper-block) of the leaf's scale (stablelm 2.5e-5, granite-moe 4.4e-5,
# falcon-mamba 1.9e-6; the widest of ULP_MOVES moves), and five AdamW steps
# from the moved weights part from the unmoved ones' run by up to 0.4%,
# 4.7% and 1.8% in loss and 19%, 50% and 53% in grad norm: AdamW's first
# update moves every element by about lr whatever its gradient's size, so
# an element whose gradient lies below the rounding takes either sign. A
# value that JAX itself does not resolve to its tolerance is held to
# RESOLUTION_FACTOR times JAX's own widest move over ULP_MOVES such moves,
# measured in the test for that value alone.
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
