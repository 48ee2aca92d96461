"""The port's encoder-decoder family (seamless-m4t, the paper's Sec. V
block) against the JAX package's, on the same weights, on the CPU.

Both packages get one set of fp32 weights (``repro.models.init_from_template``
carried across by ``repro_torch.convert.params_from_numpy``) and the
same numpy-seeded inputs (each package's ``make_inputs``, equal bit for
bit). Prompts are 5 decoder tokens against 7 frames, so the
cross-attention has Sq != Skv. Tolerance: 1e-4 of the reference's
largest magnitude (at least 1), as tests/test_torch_moe.py. Both sides
are fp32 and sum in another order (JAX's chunked online softmax and XLA's
dots against one materialized softmax and PyTorch's dots); the smoke
weights' fan-in rule reads the 4 heads, so wq has std 0.5 and scores
reach ~60, and the two sides part by up to 3e-5 of scale (slot-batched
logits after three decode steps). Evaluated in fp64, one cross-attention
block puts each side 2e-5 from the exact value at a scale of 29. Greedy
tokens agree exactly. The kernels' plain versions are held to 1e-5 of
scale against the Pallas kernels, as tests/test_torch_kernels.py. They
are held in interpret mode at head_dim 8 (paper-block's) and 16 (the
smoke configs'), with Sq != Skv.
"""

import dataclasses
import functools

import jax
import jax.extend.core as _jax_core

# The reference serving stack (its partition module is held against the
# port's below) imports jax.core.{Literal, ClosedJaxpr, Jaxpr}, which jax
# 0.9 moved to jax.extend.core: restore the old names first, as
# tests/test_torch_serving.py does.
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
from repro.kernels.decode_attention.decode_attention import decode_attention_bhsd  # noqa: E402
from repro.kernels.flash_attention.flash_attention import flash_attention_bhsd  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models import init_from_template as jax_init  # noqa: E402
from repro.models.inputs import ENC_LEN_DECODE as JAX_ENC_LEN_DECODE  # noqa: E402
from repro.models.inputs import make_inputs as jax_make_inputs  # noqa: E402
from repro.serving.partition import stage_configs as jax_stage_configs  # noqa: E402
from repro_torch.configs import ShapeCell, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import cache_from_numpy, cache_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.models import attention, build_model, count_params, encdec  # noqa: E402
from repro_torch.models.inputs import ENC_LEN_DECODE, input_specs, make_inputs  # noqa: E402
from repro_torch.serving import stage_configs  # noqa: E402

ARCHS = ["seamless-m4t-large-v2", "paper-block"]
REL = 1e-4  # of scale: model entry points and sub-blocks
KERNEL_REL = 1e-5  # of scale: the kernels' plain versions


def _close(got, want, err_msg="", rel=REL):
    """Within ``rel`` of the reference's largest magnitude (at least 1)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0, err_msg=err_msg)
S_SRC, S_TGT, MAX_LEN = 7, 5, 16


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jax model, jitted jax entry points, jax params, port model, port
    params, numpy tree) on one set of fp32 smoke weights; the qkv biases
    are switched on with random values, so the bias paths run."""
    jcfg = dataclasses.replace(_fp32(jax_smoke_config(arch)), qkv_bias=True)
    jmodel = jax_build_model(jcfg)
    tree = jax.tree.map(np.asarray, jax_init(jmodel.template, jax.random.PRNGKey(0), "float32"))
    rng = np.random.default_rng(1)
    for part in (tree["encoder"]["attn"], tree["decoder"]["self_attn"],
                 tree["decoder"]["cross_attn"]):
        for name in ("bq", "bk", "bv"):
            part[name] = (0.1 * rng.standard_normal(part[name].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jit = dict(
        prefill=jax.jit(jmodel.prefill, static_argnums=2),
        decode_step=jax.jit(jmodel.decode_step),
        prefill_batch=jax.jit(jmodel.prefill_batch, static_argnums=2),
        decode_batch=jax.jit(jmodel.decode_batch),
        encode=jax.jit(lambda p, f: jax_encdec.encode(p, f, jcfg)),
    )
    tcfg = dataclasses.replace(_fp32(get_smoke_config(arch)), qkv_bias=True)
    tmodel = build_model(tcfg)
    return jmodel, jit, jparams, tmodel, params_from_numpy(tree, device="cpu"), tree


def _batch(cfg, B, seed):
    """B requests of S_TGT decoder tokens and S_SRC frames, from the port's
    make_inputs (equal to JAX's, test_make_inputs_equal_jax)."""
    frames = make_inputs(cfg, ShapeCell("f", "prefill", S_SRC, B), seed, device="cpu")["frames"]
    tokens = make_inputs(cfg, ShapeCell("t", "prefill", S_TGT, B), seed + 1,
                         device="cpu")["tokens"]
    return {"tokens": tokens, "frames": frames}


def _jnp(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Configs, templates, inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_template_leaves_and_shapes_match_jax(arch):
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        got = jax.tree_util.tree_leaves_with_path(build_model(cfg).template,
                                                  is_leaf=lambda x: hasattr(x, "shape"))
        want = jax.tree_util.tree_leaves_with_path(jax_build_model(jcfg).template,
                                                   is_leaf=lambda x: hasattr(x, "shape"))
        assert [(jax.tree_util.keystr(p), s.shape, s.init) for p, s in got] == \
               [(jax.tree_util.keystr(p), s.shape, s.init) for p, s in want]


@pytest.mark.parametrize("arch", ARCHS + ["internvl2-76b", "stablelm-1.6b"])
@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_make_inputs_equal_jax(arch, cell):
    """The same leaves, shapes and values, bit for bit, at a small seq_len
    and batch of each kind of cell."""
    jcell = dataclasses.replace(JAX_SHAPES[cell], seq_len=9, global_batch=2)
    cell_ = ShapeCell(jcell.name, jcell.kind, jcell.seq_len, jcell.global_batch)
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    got = make_inputs(cfg, cell_, seed=4, device="cpu")
    want = jax_make_inputs(jcfg, jcell, seed=4)
    assert list(got) == list(want) == list(input_specs(cfg, cell_))
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(want[name], np.float32), err_msg=name)
    assert ENC_LEN_DECODE == JAX_ENC_LEN_DECODE


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_encode_matches_jax(arch):
    _, jit, jparams, tmodel, tparams, _ = _pair(arch)
    frames = _batch(tmodel.cfg, 2, 0)["frames"]
    got = encdec.encode(tparams, frames, tmodel.cfg)
    want = jit["encode"](jparams, jnp.asarray(frames.numpy()))
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(arch):
    _, jit, jparams, tmodel, tparams, _ = _pair(arch)
    batch = _batch(tmodel.cfg, 2, 10)
    logits, cache = tmodel.prefill(tparams, batch, MAX_LEN)
    jlogits, jcache = jit["prefill"](jparams, _jnp(batch), MAX_LEN)
    _close(logits.numpy(), np.asarray(jlogits))
    assert cache["len"].tolist() == [S_TGT, S_TGT] and int(jcache["len"]) == S_TGT
    for name in ("k", "v", "ck", "cv"):
        assert tuple(cache[name].shape) == jcache[name].shape, name
        _close(cache[name].numpy(), np.asarray(jcache[name]), err_msg=name)
    assert cache["ck"].shape[2] == S_SRC != S_TGT


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_jax(arch):
    """8 greedy steps from the prefill: token for token, logits within
    1e-5, and the self cache after them."""
    _, jit, jparams, tmodel, tparams, _ = _pair(arch)
    batch = _batch(tmodel.cfg, 2, 20)
    logits, cache = tmodel.prefill(tparams, batch, MAX_LEN)
    jlogits, jcache = jit["prefill"](jparams, _jnp(batch), MAX_LEN)
    for _ in range(8):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        jtok = jnp.argmax(jlogits[:, -1], -1, keepdims=True)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        logits, cache = tmodel.decode_step(tparams, tok, cache)
        jlogits, jcache = jit["decode_step"](jparams, jtok, jcache)
        _close(logits.numpy(), np.asarray(jlogits))
    assert cache["len"].tolist() == [S_TGT + 8] * 2 and int(jcache["len"]) == S_TGT + 8
    for name in ("k", "v"):
        _close(cache[name].numpy(), np.asarray(jcache[name]), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_batched_entry_points_match_jax_vmap(arch):
    """prefill_batch into lanes 0, 2, 3 of a 4-lane slot cache against
    JAX's vmapped prefill_batch; then decode steps over every lane with
    lane 2 masked out, against JAX's decode_batch with the engine's masked
    merge. The masked lane's rows and length stay as they were."""
    _, jit, jparams, tmodel, tparams, _ = _pair(arch)
    batch = _batch(tmodel.cfg, 3, 30)
    cache = tmodel.init_cache(4, MAX_LEN, "cpu", S_SRC)
    lanes = torch.tensor([0, 2, 3])
    out = tmodel.prefill_batch(tparams, batch, cache, lanes)
    jbatch = {k: v[:, None] for k, v in _jnp(batch).items()}  # [N, 1, ...] per request
    jout, jcaches = jit["prefill_batch"](jparams, jbatch, MAX_LEN)
    _close(out.numpy(), np.asarray(jout)[:, 0])
    # The JAX slot caches: lane 1 is an empty slot (zeros, length 0).
    jcaches = jax.tree.map(lambda a: jnp.zeros((4,) + a.shape[1:], a.dtype).at[
        jnp.array([0, 2, 3])].set(a), jcaches)
    got = cache_to_numpy(cache)
    for name in ("len", "k", "v", "ck", "cv"):
        _close(got[name], np.asarray(jcaches[name]), err_msg=name)
    mask = np.array([True, False, False, True])
    active = torch.tensor(np.flatnonzero(mask))
    tok = torch.tensor([[3], [5], [7], [11]])
    for step in range(3):
        before = {k: v.clone() for k, v in cache.items()}
        out = tmodel.decode_batch(tparams, tok, cache, active)
        jout, jnew = jit["decode_batch"](jparams, jnp.asarray(tok.numpy())[:, None], jcaches)
        jcaches = jax.tree.map(lambda n, o: jnp.where(
            jnp.asarray(mask).reshape((4,) + (1,) * (n.ndim - 1)), n, o), jnew, jcaches)
        _close(out[mask].numpy(), np.asarray(jout)[mask][:, 0])
        got = cache_to_numpy(cache)
        for name in ("len", "k", "v", "ck", "cv"):
            _close(got[name], np.asarray(jcaches[name]), err_msg=f"{name} after step {step}")
        for name, t in cache.items():
            assert torch.equal(t[:, 2] if t.ndim > 1 else t[2],
                               before[name][:, 2] if t.ndim > 1 else before[name][2]), name
        tok = out[:, -1].argmax(-1, keepdim=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_from_numpy_carries_the_cross_cache(arch):
    _, jit, jparams, tmodel, tparams, _ = _pair(arch)
    batch = _batch(tmodel.cfg, 2, 40)
    _, jcache = jit["prefill"](jparams, _jnp(batch), MAX_LEN)
    cache = cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    assert sorted(cache) == ["ck", "cv", "k", "len", "v"]
    assert cache["len"].tolist() == [S_TGT] * 2
    back = cache_from_numpy(cache_to_numpy(cache), device="cpu")
    for name in cache:
        assert torch.equal(back[name], cache[name]), name
    # The converted cache decodes as the port's own prefill's does.
    _, own = tmodel.prefill(tparams, batch, MAX_LEN)
    tok = torch.tensor([[1], [2]])
    a, _ = tmodel.decode_step(tparams, tok, cache)
    b, _ = tmodel.decode_step(tparams, tok, own)
    _close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_refuses_frames_that_do_not_fill_the_cross_cache(arch):
    _, _, _, tmodel, tparams, _ = _pair(arch)
    cache = tmodel.init_cache(2, MAX_LEN, "cpu", S_SRC + 1)
    with pytest.raises(ValueError, match="cross cache"):
        tmodel.prefill_batch(tparams, _batch(tmodel.cfg, 2, 0), cache, torch.arange(2))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_match_jax(arch):
    cfg = get_config(arch)
    tmodel, jmodel = build_model(cfg), jax_build_model(jax_get_config(arch))
    for enc_len in (None, 1000):
        got = tmodel.cache_shapes(4, 64, enc_len)
        want = jmodel.cache_shapes(4, 64, enc_len)
        assert {k: s for k, (s, _) in got.items() if k != "len"} == \
               {k: v.shape for k, v in want.items() if k != "len"}
        assert got["len"][0] == (4,)  # one length per lane; JAX vmaps a scalar


def test_stage_configs_refuse_an_encoder_decoder():
    for arch in ARCHS:
        with pytest.raises(NotImplementedError, match="decoder-only"):
            stage_configs(get_smoke_config(arch), 2)
        with pytest.raises(NotImplementedError, match="decoder-only"):
            jax_stage_configs(jax_smoke_config(arch), 2)
        assert build_model(get_smoke_config(arch)).decode_paged is None


@pytest.mark.parametrize("arch,n", [("seamless-m4t-large-v2", 1_370_824_704),
                                    ("paper-block", 944_237_568)])
def test_full_size_parameter_counts(arch, n):
    assert count_params(build_model(get_config(arch)).template) == n


# ---------------------------------------------------------------------------
# Attention sub-blocks and the kernels' plain versions
# ---------------------------------------------------------------------------

def _layer(tree, part):
    return {k: v[0] for k, v in part(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bidirectional_attention_block_matches_jax(arch, impl):
    """An encoder layer's attention_block(causal=False) on the plain path
    against JAX's XLA chunked attention and its Pallas kernel
    (interpret)."""
    _, _, _, tmodel, _, tree = _pair(arch)
    jcfg = dataclasses.replace(_fp32(jax_smoke_config(arch)), qkv_bias=True, attn_impl=impl)
    p = _layer(tree, lambda t: t["encoder"]["attn"])
    x = np.random.default_rng(5).standard_normal((2, S_SRC, tmodel.cfg.d_model)).astype(
        np.float32)
    got, (k, v) = attention.attention_block(torch.from_numpy(x), {n: torch.from_numpy(a) for
                                            n, a in p.items()}, tmodel.cfg,
                                            positions=torch.arange(S_SRC), causal=False)
    want, (jk, jv) = jax_attention.attention_block(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg, positions=jnp.arange(S_SRC),
        window=None, causal=False)
    _close(got.numpy(), np.asarray(want))
    _close(k.numpy(), np.asarray(jk))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("route", ["prompt", "decode"])
def test_cross_attention_block_matches_jax(arch, route):
    """cross_attention_block on both routes (a 5-token prompt through the
    flash plain version, one token through the decode plain version over
    every cross row) against JAX's, which runs XLA's chunked attention,
    on the encoder-output K/V of project_kv (held against JAX's too)."""
    _, _, _, tmodel, _, tree = _pair(arch)
    cfg = tmodel.cfg
    jcfg = dataclasses.replace(_fp32(jax_smoke_config(arch)), qkv_bias=True)
    p = _layer(tree, lambda t: t["decoder"]["cross_attn"])
    tp, jp = {n: torch.from_numpy(a) for n, a in p.items()}, jax.tree.map(jnp.asarray, p)
    rng = np.random.default_rng(6)
    Sq = S_TGT if route == "prompt" else 1
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, S_SRC, cfg.d_model)).astype(np.float32)
    kv = attention.project_kv(torch.from_numpy(enc), tp, cfg)
    jkv = jax_attention.project_kv(jnp.asarray(enc), jp, jcfg)
    for a, b in zip(kv, jkv):
        _close(a.numpy(), np.asarray(b))
    lengths = None if route == "prompt" else torch.full((2,), S_SRC, dtype=torch.int32)
    got = attention.cross_attention_block(torch.from_numpy(x), kv, tp, cfg, lengths=lengths)
    want = jax_attention.cross_attention_block(jnp.asarray(x), jkv, jp, jcfg)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("D", [8, 16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Skv,H,KV", [(5, 7, 4, 4), (16, 16, 100, 100), (8, 40, 6, 2)])
def test_flash_plain_matches_pallas_at_small_head_dims(D, causal, Sq, Skv, H, KV):
    """The flash plain version against the Pallas kernel (interpret) at
    head_dim 8 and 16, Sq != Skv (cross) and paper-block's 100 heads."""
    rng = np.random.default_rng(D * 100 + Sq + Skv)
    q = rng.standard_normal((2, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((2, KV, Skv, D)).astype(np.float32)
    v = rng.standard_normal((2, KV, Skv, D)).astype(np.float32)
    want = flash_attention_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                block_q=8, block_kv=8, interpret=True)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal)
    _close(got.numpy(), np.asarray(want), rel=KERNEL_REL)


@pytest.mark.parametrize("D", [8, 16])
@pytest.mark.parametrize("S,lengths", [(32, [0, 1, 17, 32]), (16, [16, 16, 16, 16])])
def test_decode_plain_matches_pallas_at_small_head_dims(D, S, lengths):
    """The decode plain version against the Pallas kernel (interpret) at
    head_dim 8 and 16: a self cache with an empty lane, and a cross cache
    whose lanes all see every row."""
    rng = np.random.default_rng(D + S)
    B, H, KV = 4, 4, 4
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kc = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    vc = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    want = np.asarray(decode_attention_bhsd(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                            jnp.asarray(lens), chunk=8, interpret=True))
    got = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                               torch.from_numpy(lens)).numpy()
    seen = lens > 0  # a lane of length 0: the kernel outputs 0, the plain version an average
    _close(got[seen], want[seen], rel=KERNEL_REL)
    assert not want[~seen].any()
