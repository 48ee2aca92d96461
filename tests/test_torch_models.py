"""The port's models against the JAX package's, on the same weights.

Weights come from ``repro.models.init_from_template`` and reach the port
through ``repro_torch.convert.params_from_numpy``; prompts are numpy
draws from a seed. Everything is fp32 on the CPU. Logits and cache rows
agree to ``atol=1e-4`` (matmul summation order over two layers), except
phi4's at 1e-3: its smoke config has 2 KV heads, so the template's fan-in
rule (``ParamSpec.initializer_std`` reads ``shape[-2]`` = KV) draws wk/wv
with std 0.7, scores reach ~100 and the softmax amplifies fp32 rounding —
measured 3.5e-4 on logits of magnitude 26. Greedy tokens agree exactly.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import direct_greedy
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import init_from_template as jax_init
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.models import build_model
from repro_torch.serving import partition_model

ARCHS = [
    "stablelm-1.6b",  # MHA
    "qwen2.5-14b",  # GQA KV=1, qkv_bias
    "phi4-mini-3.8b",  # GQA KV=2, tied embeddings
    "granite-20b",  # MQA KV=1, gelu MLP
]
ATOL = {"stablelm-1.6b": 1e-4, "qwen2.5-14b": 1e-4, "phi4-mini-3.8b": 1e-3, "granite-20b": 1e-4}


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jax model, jax params, port model, port params) on one set of
    weights. The zero-initialized qkv biases are replaced by random
    values so the bias path is exercised. The JAX entry points are
    jitted (eager JAX dispatches op by op and dominates the run time)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32", param_dtype="float32")
    jmodel = jax_build_model(jcfg)
    tree = jax.tree.map(np.asarray, jax_init(jmodel.template, jax.random.PRNGKey(0), "float32"))
    rng = np.random.default_rng(1)
    attn = tree["classes"]["c0"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (0.1 * rng.standard_normal(attn[name].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jmodel = types.SimpleNamespace(
        prefill=jax.jit(jmodel.prefill, static_argnums=2),
        decode_step=jax.jit(jmodel.decode_step),
        decode_batch=jax.jit(jmodel.decode_batch),
    )
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", param_dtype="float32")
    return jmodel, jparams, build_model(tcfg), params_from_numpy(tree, device="cpu")


def _close(got, want, arch):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL[arch], rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    rng = np.random.default_rng(7)
    V = tmodel.cfg.vocab_size
    toks = rng.integers(0, V, size=(2, 9)).astype(np.int32)
    max_len = 32
    j_logits, j_cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
    t_logits, t_cache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)}, max_len)
    assert t_logits.shape == (2, 1, V)
    _close(t_logits, j_logits, arch)
    _close(t_cache["c0"]["k"], j_cache["c0"]["k"], arch)
    _close(t_cache["c0"]["v"], j_cache["c0"]["v"], arch)
    assert t_cache["len"].tolist() == [9, 9]
    for _ in range(3):
        nxt = rng.integers(0, V, size=(2, 1)).astype(np.int32)
        j_logits, j_cache = jmodel.decode_step(jparams, jnp.asarray(nxt), j_cache)
        t_logits, t_cache = tmodel.decode_step(tparams, torch.from_numpy(nxt), t_cache)
        _close(t_logits, j_logits, arch)
    _close(t_cache["c0"]["k"], j_cache["c0"]["k"], arch)
    assert t_cache["len"].tolist() == [int(j_cache["len"])] * 2


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-20b"])
def test_token_ids_past_the_vocabulary_read_the_last_row_as_in_jax(arch):
    """A speculative draft ingests its target's tokens, which may lie past
    its own vocabulary: the JAX gather clamps such an id to the last row,
    and so does the port (torch indexing would raise)."""
    jmodel, jparams, tmodel, tparams = _pair(arch)
    V = tmodel.cfg.vocab_size
    toks = np.asarray([[3, V, V + 7, 1, 2 * V + 1], [V - 1, 0, V + 100, 5, 9]], np.int32)
    j_logits, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    t_logits, _ = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 16)
    _close(t_logits, j_logits, arch)
    clamped, _ = tmodel.prefill(tparams, {"tokens": torch.from_numpy(np.minimum(toks, V - 1))}, 16)
    torch.testing.assert_close(t_logits, clamped, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_decode_ragged_lengths_matches_jax(arch):
    """Per-lane lengths in one call vs JAX's vmapped decode_batch over
    slot-stacked per-request caches; a call over a subset of lanes leaves
    the other lanes' rows and lengths untouched."""
    jmodel, jparams, tmodel, tparams = _pair(arch)
    rng = np.random.default_rng(11)
    V, max_len = tmodel.cfg.vocab_size, 24
    caches = []
    for L in (3, 10, 1, 7):
        prompt = rng.integers(0, V, size=(1, L)).astype(np.int32)
        caches.append(jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, max_len)[1])
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
    nxt = rng.integers(0, V, size=(4, 1)).astype(np.int32)
    j_logits, j_new = jmodel.decode_batch(jparams, jnp.asarray(nxt)[:, None], stacked)

    t_cache = cache_from_numpy(stacked, device="cpu")
    assert t_cache["len"].tolist() == [3, 10, 1, 7]
    t_logits = tmodel.decode_batch(tparams, torch.from_numpy(nxt), t_cache,
                                   torch.arange(4))
    _close(t_logits, np.asarray(j_logits)[:, 0], arch)
    got = cache_to_numpy(t_cache)
    np.testing.assert_array_equal(got["len"], np.asarray(j_new["len"]))
    _close(got["c0"]["k"], j_new["c0"]["k"], arch)

    sub = cache_from_numpy(stacked, device="cpu")
    lanes = torch.tensor([0, 2])
    sub_logits = tmodel.decode_batch(tparams, torch.from_numpy(nxt), sub, lanes)
    torch.testing.assert_close(sub_logits[lanes], t_logits[lanes], rtol=0, atol=1e-6)
    assert sub["len"].tolist() == [4, 10, 2, 7]
    before = cache_from_numpy(stacked, device="cpu")
    for lane in (1, 3):
        assert torch.equal(sub["c0"]["k"][:, lane], before["c0"]["k"][:, lane])
        assert torch.equal(sub["c0"]["v"][:, lane], before["c0"]["v"][:, lane])


def _greedy(model, params, prompt, n_tokens, max_len=64):
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]}, max_len)
    toks = [int(logits[0, -1].argmax())]
    for _ in range(n_tokens - 1):
        logits, cache = model.decode_step(params, torch.tensor([[toks[-1]]]), cache)
        toks.append(int(logits[0, -1].argmax()))
    return toks


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_direct_greedy(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    rng = np.random.default_rng(3)
    for L in (5, 12):
        prompt = rng.integers(0, tmodel.cfg.vocab_size, size=L).astype(np.int32)
        assert _greedy(tmodel, tparams, prompt, 8) == direct_greedy(jmodel, jparams, prompt, 8)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("G", [2, 3])
def test_partitioned_stages_equal_whole_model(arch, G):
    _, _, tmodel, tparams = _pair(arch)
    rng = np.random.default_rng(G)
    toks = torch.from_numpy(rng.integers(0, tmodel.cfg.vocab_size, size=(2, 6)))
    whole_logits, whole_cache = tmodel.prefill(tparams, {"tokens": toks}, 16)
    stages = partition_model(tmodel.cfg, tparams, G)
    x, caches = toks, []
    for g, (model_g, params_g) in enumerate(stages):
        x, cache_g = model_g.prefill(params_g, {"tokens" if g == 0 else "hidden": x}, 16)
        caches.append(cache_g)
    torch.testing.assert_close(x, whole_logits, rtol=0, atol=1e-6)
    for _ in range(3):
        nxt = whole_logits[:, -1].argmax(-1, keepdim=True)
        whole_logits, whole_cache = tmodel.decode_step(tparams, nxt, whole_cache)
        x = nxt
        for (model_g, params_g), cache_g in zip(stages, caches):
            x, _ = model_g.decode_step(params_g, x, cache_g)
        torch.testing.assert_close(x, whole_logits, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["internvl2-76b", "paper-block", "seamless-m4t-large-v2"])
def test_unported_architectures_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config(arch)


def test_unported_layer_kinds_raise():
    vlm = dataclasses.replace(get_smoke_config("stablelm-1.6b"), frontend="patches",
                              frontend_dim=32, n_frontend_tokens=4)
    with pytest.raises(NotImplementedError, match="patches frontend"):
        build_model(vlm)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"])
def test_moe_architectures_build(arch):
    """The MoE decoders, which raised before their slice, build at full
    size and smoke size with the JAX template's leaves."""
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        layers = build_model(cfg).template["classes"]["c0"]
        assert "moe" in layers and "mlp" not in layers
        jax_layers = jax_build_model(jcfg).template["classes"]["c0"]
        assert {n: s.shape for n, s in layers["moe"].items()} == {
            n: s.shape for n, s in jax_layers["moe"].items()}
