"""The port's internvl2 patches frontend against the JAX package's, on the
same weights, on the CPU.

internvl2-smoke (2 layers, d_model 64, 4 / 2 heads, 4 patch positions of
width 48) in fp32 on both sides: weights from
``repro.models.init_from_template`` carried across by
``repro_torch.convert.params_from_numpy``, tokens and patch embeddings
from each package's ``make_inputs`` (equal bit for bit). A prefill whose
batch holds ``patch_embeds`` takes the projected patches at its first
positions; the serving engines pass tokens only, so the servers are held
token for token on a text-only workload. Tolerance: 1e-4 of the
reference's largest magnitude (at least 1), as tests/test_torch_moe.py
(two layers of fp32 matmuls summed in another order); greedy tokens
agree exactly.
"""

import dataclasses
import functools

import jax
import jax.extend.core as _jax_core

# The reference serving stack imports jax.core.{Literal, ClosedJaxpr,
# Jaxpr}, which jax 0.9 moved to jax.extend.core: restore the old names
# first, as tests/test_torch_serving.py does.
for _name in ("Literal", "ClosedJaxpr", "Jaxpr"):
    if not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(_jax_core, _name))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import init_from_template as jax_init  # noqa: E402
from repro.models.inputs import make_inputs as jax_make_inputs  # noqa: E402
from repro.serving import PipelineServer as JaxPipelineServer  # noqa: E402
from repro.serving.partition import slice_stage_params as jax_slice_stage_params  # noqa: E402
from repro_torch.configs import ShapeCell, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import build_model, count_params  # noqa: E402
from repro_torch.models.inputs import make_inputs  # noqa: E402
from repro_torch.serving import PipelineServer, partition_model, slice_stage_params  # noqa: E402

ARCH = "internvl2-76b"
REL = 1e-4
S, MAX_LEN = 10, 32
SERVER_KW = dict(n_groups=2, n_replicas=3, max_len=128, max_batch=4, seed=0)


def _close(got, want, err_msg=""):
    """Within REL of the reference's largest magnitude (at least 1)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=REL * scale, rtol=0, err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def _pair():
    """(jax model, jitted prefill / decode, jax params, port model, port
    params, numpy tree) on one set of fp32 smoke weights."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32", param_dtype="float32")
    jmodel = jax_build_model(jcfg)
    tree = jax.tree.map(np.asarray, jax_init(jmodel.template, jax.random.PRNGKey(0), "float32"))
    jparams = jax.tree.map(jnp.asarray, tree)
    jit = dict(prefill=jax.jit(jmodel.prefill, static_argnums=2),
               decode_step=jax.jit(jmodel.decode_step))
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", param_dtype="float32")
    return jmodel, jit, jparams, build_model(tcfg), params_from_numpy(tree, device="cpu"), tree


def _batch(seed):
    """Two prompts of S tokens whose first 4 positions are patches."""
    _, _, _, tmodel, _, _ = _pair()
    return make_inputs(tmodel.cfg, ShapeCell("p", "prefill", S, 2), seed, device="cpu")


def _jnp(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def test_template_leaves_and_shapes_match_jax():
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        got = jax.tree_util.tree_leaves_with_path(build_model(cfg).template,
                                                  is_leaf=lambda x: hasattr(x, "shape"))
        want = jax.tree_util.tree_leaves_with_path(jax_build_model(jcfg).template,
                                                   is_leaf=lambda x: hasattr(x, "shape"))
        assert [(jax.tree_util.keystr(p), s.shape) for p, s in got] == \
               [(jax.tree_util.keystr(p), s.shape) for p, s in want]
    assert build_model(get_config(ARCH)).template["vision_proj"].shape == (3200, 8192)
    assert count_params(build_model(get_config(ARCH)).template) == 70_579_920_896


def test_make_inputs_carry_patch_embeds_like_jax():
    cell = dataclasses.replace(JAX_SHAPES["prefill_32k"], seq_len=S, global_batch=2)
    want = jax_make_inputs(jax_smoke_config(ARCH), cell, seed=3)
    got = make_inputs(get_smoke_config(ARCH), ShapeCell(cell.name, cell.kind, S, 2), 3,
                      device="cpu")
    assert list(got) == list(want) == ["tokens", "patch_embeds"]
    assert tuple(got["patch_embeds"].shape) == (2, 4, 48)
    for name in want:
        np.testing.assert_array_equal(got[name].float().numpy(), np.asarray(want[name]))


def test_prefill_with_patches_and_decode_match_jax():
    """Prefill logits and cache with patch_embeds, then 8 greedy decode
    steps token for token, logits within tolerance."""
    _, jit, jparams, tmodel, tparams, _ = _pair()
    batch = _batch(0)
    logits, cache = tmodel.prefill(tparams, batch, MAX_LEN)
    jlogits, jcache = jit["prefill"](jparams, _jnp(batch), MAX_LEN)
    _close(logits, jlogits)
    for name in ("k", "v"):
        _close(cache["c0"][name], jcache["c0"][name], name)
    for _ in range(8):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        jtok = jnp.argmax(jlogits[:, -1], -1, keepdims=True)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        logits, cache = tmodel.decode_step(tparams, tok, cache)
        jlogits, jcache = jit["decode_step"](jparams, jtok, jcache)
        _close(logits, jlogits)
    _close(cache["c0"]["k"], jcache["c0"]["k"])


def test_patches_replace_the_first_positions():
    """The patches replace the embeddings of their positions only: layer
    0's K rows (projections of its input, before any mixing) equal a
    text-only prefill's past the patch positions and differ at them, and
    the logits differ."""
    _, _, _, tmodel, tparams, _ = _pair()
    batch = _batch(1)
    with_p, cache_p = tmodel.prefill(tparams, batch, MAX_LEN)
    text, cache_t = tmodel.prefill(tparams, {"tokens": batch["tokens"]}, MAX_LEN)
    assert not torch.allclose(with_p, text)
    P = batch["patch_embeds"].shape[1]
    k_p, k_t = cache_p["c0"]["k"][0], cache_t["c0"]["k"][0]
    torch.testing.assert_close(k_p[:, P:S], k_t[:, P:S], rtol=0, atol=0)
    assert not torch.allclose(k_p[:, :P], k_t[:, :P])


@pytest.mark.parametrize("G", [2, 3])
def test_stage_zero_alone_holds_vision_proj(G):
    _, _, jparams, tmodel, tparams, _ = _pair()
    ours = slice_stage_params(tmodel.cfg, tparams, G)
    theirs = jax_slice_stage_params(jax_smoke_config(ARCH), jparams, G)
    assert ["vision_proj" in t for t in ours] == ["vision_proj" in t for t in theirs] == \
           [True] + [False] * (G - 1)
    assert ours[0]["vision_proj"] is tparams["vision_proj"]  # a view: nothing copied
    stages = partition_model(tmodel.cfg, tparams, G)
    assert ["vision_proj" in m.template for m, _ in stages] == [True] + [False] * (G - 1)


@pytest.mark.parametrize("G", [2, 3])
def test_partitioned_prefill_with_patches_equals_whole_model(G):
    """Stage 0 takes the patches; the later stages take its hidden states."""
    _, _, _, tmodel, tparams, _ = _pair()
    batch = _batch(2)
    whole, _ = tmodel.prefill(tparams, batch, MAX_LEN)
    x = None
    for g, (model_g, params_g) in enumerate(partition_model(tmodel.cfg, tparams, G)):
        x, _ = model_g.prefill(params_g, batch if g == 0 else {"hidden": x}, MAX_LEN)
    torch.testing.assert_close(x, whole, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def weights():
    jmodel, _, jparams, tmodel, tparams, _ = _pair()
    return (jmodel, jparams), (tmodel, tparams)


def _recording(server):
    """Record every request ``submit`` returns (``run`` discards them)."""
    reqs = []
    submit = server.submit

    def recorded(*args, **kwargs):
        req = submit(*args, **kwargs)
        reqs.append(req)
        return req

    server.submit = recorded
    return reqs


@pytest.mark.parametrize("async_depth", [0, 2])
def test_server_matches_reference(weights, async_depth):
    """PipelineServer at G=2, token for token with equal ServerStats."""
    (jmodel, jparams), (tmodel, tparams) = weights
    ref = JaxPipelineServer(jmodel, jparams, async_depth=async_depth, **SERVER_KW)
    ours = PipelineServer(tmodel, tparams, async_depth=async_depth, device="cpu", **SERVER_KW)
    ref_reqs, our_reqs = _recording(ref), _recording(ours)
    ref.run(30, arrival_p=0.5)
    ours.run(30, arrival_p=0.5)
    assert len(our_reqs) == len(ref_reqs) > 0
    for got, want in zip(our_reqs, ref_reqs):
        assert (got is None) == (want is None)
        if want is not None:
            assert got.generated == want.generated, got.rid
            assert (got.done, got.dropped) == (want.done, want.dropped)
    stats = dataclasses.asdict(ours.stats)
    for name, value in stats.items():
        if name == "energy_charged":
            assert value == pytest.approx(ref.stats.energy_charged, abs=1e-9)
        else:
            assert value == getattr(ref.stats, name), name
    assert ours.stats.tokens_generated > 0
    first, second = (ours._params_for(g, 0).shards[0] for g in (0, 1))  # placed stage trees
    assert "vision_proj" in first and "vision_proj" not in second
