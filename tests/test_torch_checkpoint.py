"""The port's checkpoints (``repro_torch.ft.checkpoint``) on the CPU: the
JAX package's checkpoint tests (tests/test_ft.py ``TestCheckpoint``) on
the port, and checkpoints crossing packages both ways on a smoke model's
``TrainState``: the port names every leaf as ``jax.tree_util.keystr``
does, JAX restores what the port wrote and the port what JAX wrote, bf16
leaves included, bit for bit.
"""

import dataclasses
import json
import os

import jax
import jax.extend.core as _jax_core

# repro.ft imports repro.serving, whose modules import jax.core.{Literal,
# ClosedJaxpr, Jaxpr}, which jax 0.9 moved to jax.extend.core: restore the
# old names first, as tests/test_torch_serving.py does.
for _name in ("Literal", "ClosedJaxpr", "Jaxpr"):
    if not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(_jax_core, _name))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.serving  # noqa: E402,F401  (before repro.ft: their import order is circular)
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.ft import restore_checkpoint as jax_restore  # noqa: E402
from repro.ft import save_checkpoint as jax_save  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import init_from_template as jax_init  # noqa: E402
from repro.training import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.ft import (  # noqa: E402
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import init_train_state  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402


def tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16),
                   "c": torch.tensor(7, dtype=torch.int32)},
    }


# JAX's TestCheckpoint, on the port.

def test_round_trip(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 5, t)
    restored, step = restore_checkpoint(str(tmp_path), t)
    assert step == 5
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_retention(tmp_path):
    t = tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, t, keep=3)
    assert list_steps(str(tmp_path)) == [3, 4, 5]
    assert latest_step(str(tmp_path)) == 5


def test_structure_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, tree())
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"different": torch.zeros(3)})


def test_no_partial_checkpoint_visible(tmp_path):
    """A tmp dir (simulated crash) is never listed as a checkpoint."""
    save_checkpoint(str(tmp_path), 1, tree())
    os.makedirs(tmp_path / ".tmp_step_0000000002")
    assert list_steps(str(tmp_path)) == [1]


def test_restore_specific_step(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 1, t, keep=10)
    t2 = {"a": t["a"] + 1, "nested": {k: v + 1 for k, v in t["nested"].items()}}
    save_checkpoint(str(tmp_path), 2, t2, keep=10)
    restored, step = restore_checkpoint(str(tmp_path), t, step=1)
    assert step == 1
    assert torch.equal(restored["a"], t["a"])


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), tree())


# Across packages.

@pytest.fixture(scope="module")
def states():
    """One granite-moe-smoke TrainState in both packages (fp32 params from
    JAX's init, one leaf bf16, moments and counts set to nonzero values)."""
    arch = "granite-moe-1b-a400m"
    fp32 = dict(dtype="float32", param_dtype="float32")
    jmodel = jax_build_model(dataclasses.replace(jax_smoke_config(arch), **fp32))
    tree_np = jax.tree.map(np.asarray, jax_init(jmodel.template, jax.random.PRNGKey(0), "float32"))
    tree_np["final_norm"] = (tree_np["final_norm"] * 1.5).astype(jnp.bfloat16)
    jstate = jax_init_train_state(jmodel, jax.tree.map(jnp.asarray, tree_np))
    rng = np.random.default_rng(0)
    moments = {k: jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                               jax.tree.map(np.asarray, jstate.opt[k])) for k in ("m", "v")}
    jstate = dataclasses.replace(
        jstate, opt={**jax.tree.map(jnp.asarray, moments), "count": jnp.int32(3)},
        step=jnp.int32(3))
    tmodel = build_model(dataclasses.replace(get_smoke_config(arch), **fp32))
    tstate = init_train_state(tmodel, params_from_numpy(tree_np, device="cpu"))
    tstate.opt["m"] = params_from_numpy(moments["m"], device="cpu")
    tstate.opt["v"] = params_from_numpy(moments["v"], device="cpu")
    tstate.opt["count"] = torch.tensor(3, dtype=torch.int32)
    tstate.step = torch.tensor(3, dtype=torch.int32)
    assert tstate.params["final_norm"].dtype == torch.bfloat16
    return jstate, tstate


def _assert_same(jstate, tstate):
    """Equal TrainStates, leaf for leaf in JAX's order (fields, then keys sorted)."""
    jleaves = jax.tree.leaves(jstate)
    tleaves = tree_leaves(tstate.params) + tree_leaves(tstate.opt) + [tstate.step]
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))


def test_leaf_names_are_jax_keystr_names(tmp_path, states):
    jstate, tstate = states
    jax_save(str(tmp_path / "jax"), 3, jstate)
    save_checkpoint(str(tmp_path / "port"), 3, tstate)
    manifests = [json.loads((tmp_path / side / "step_0000000003" / "manifest.json").read_text())
                 for side in ("jax", "port")]
    assert manifests[0] == manifests[1]
    names = [e["name"] for e in manifests[1]["leaves"]]
    assert ".params['final_norm']" in names and ".opt['count']" in names
    assert names[-1] == ".step"


def test_port_restores_a_jax_checkpoint(tmp_path, states):
    jstate, tstate = states
    jax_save(str(tmp_path), 3, jstate)
    restored, step = restore_checkpoint(str(tmp_path), tstate)
    assert step == 3
    _assert_same(jstate, restored)
    assert restored.params["final_norm"].dtype == torch.bfloat16


def test_jax_restores_a_port_checkpoint(tmp_path, states):
    jstate, tstate = states
    save_checkpoint(str(tmp_path), 3, tstate)
    restored, step = jax_restore(str(tmp_path), jstate)
    assert step == 3
    _assert_same(restored, tstate)
    assert restored.params["final_norm"].dtype == jnp.bfloat16
