"""The port's SSM serving path against the JAX package's, on the CPU.

Inputs are numpy draws from a seed; weights are the JAX package's smoke
falcon-mamba in fp32, handed to the port through ``params_from_numpy``.
Tolerances, each for fp32 on both sides with another summation order:

* the plain selective scan against the Pallas kernel (interpret mode),
  the sequential jnp oracle and the JAX chunked associative scan: y and
  h_final within 1e-5 (abs and rel) — the associative scan multiplies the
  decay factors in another order than the recurrence;
* the plain rmsnorm against the Pallas kernel (interpret mode) and the
  jnp oracle: 1e-6 in fp32; in bf16 one bf16 rounding step (rel 2**-7);
* ``_causal_conv``, ``mamba_block`` and ``mamba_decode_step`` against the
  JAX ones on the same layer's params: 1e-5 (abs and rel);
* model prefill / decode logits and ``conv`` / ``ssm`` caches: 1e-4 abs
  (logits reach ~70 with the tied std-1 embedding; two layers of matmuls);
* partitioned stages against the whole model: 1e-6 (the same operations
  on the same device);
* the ``PipelineServer``: the same token streams and equal ``ServerStats``
  (energy within 1e-9).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import (  # the jax 0.9 import shim for repro.serving
    SERVER_KW,
    _assert_same_run,
    _drive,
    _recording,
)
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.rmsnorm import rmsnorm_ref as jax_rmsnorm_ref
from repro.kernels.rmsnorm.rmsnorm import rmsnorm_2d
from repro.kernels.selective_scan import selective_scan_ref as jax_scan_ref
from repro.kernels.selective_scan.selective_scan import selective_scan_pallas
from repro.models import build_model as jax_build_model
from repro.models import init_from_template as jax_init
from repro.models import ssm as jax_ssm
from repro.serving import PipelineServer as JaxPipelineServer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model, count_params
from repro_torch.models import ssm
from repro_torch.serving import PipelineServer, partition_model

ARCH = "falcon-mamba-7b"
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _scan_inputs(rng, B, S, Din, N, with_h0):
    """Operands as ``mamba_block`` forms them: dt a softplus (positive),
    A = -exp(.) (negative)."""
    x = rng.standard_normal((B, S, Din)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Din)))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal((Din, N)))).astype(np.float32)
    h0 = rng.standard_normal((B, Din, N)).astype(np.float32) if with_h0 else None
    return x, dt, Bm, Cm, A, h0


SCAN_CASES = [
    # B, S, Din, N, h0, chunk, block_d: S ragged against chunk, Din against block_d
    (2, 50, 96, 8, False, 16, 64),
    (1, 37, 40, 16, True, 16, 32),
    (3, 1, 24, 16, True, 8, 16),
    (2, 23, 70, 8, True, 8, 32),
]


@pytest.mark.parametrize("B,S,Din,N,with_h0,chunk,block_d", SCAN_CASES)
def test_scan_plain_matches_pallas_oracle_and_chunked(B, S, Din, N, with_h0, chunk, block_d):
    rng = np.random.default_rng(B * 100 + S + Din + N)
    x, dt, Bm, Cm, A, h0 = _scan_inputs(rng, B, S, Din, N, with_h0)
    j = [jnp.asarray(a) for a in (x, dt, Bm, Cm, A)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    y, h = selective_scan_ref(_t(x), _t(dt), _t(Bm), _t(Cm), _t(A), None if h0 is None else _t(h0))
    assert y.shape == (B, S, Din) and h.shape == (B, Din, N) and h.dtype == torch.float32
    refs = {
        "pallas": selective_scan_pallas(*j, jh0, chunk=chunk, block_d=block_d, interpret=True),
        "oracle": jax_scan_ref(*j, jh0),
        "chunked": jax_ssm.selective_scan(*j, jh0, chunk=chunk),
    }
    for name, (jy, jh) in refs.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), err_msg=name, **SCAN_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), err_msg=name, **SCAN_TOL)
    # The wrapper's CPU path is the plain version.
    y2, h2 = selective_scan(_t(x), _t(dt), _t(Bm), _t(Cm), _t(A), None if h0 is None else _t(h0))
    assert torch.equal(y2, y) and torch.equal(h2, h)


@pytest.mark.parametrize("R,D,block_rows", [(21, 64, 8), (5, 96, 256), (40, 128, 16)])
def test_rmsnorm_plain_matches_pallas_and_oracle(R, D, block_rows):
    rng = np.random.default_rng(R + D)
    x = (3.0 * rng.standard_normal((R, D))).astype(np.float32)
    w = (1.0 + 0.5 * rng.standard_normal(D)).astype(np.float32)
    got = rmsnorm(_t(x), _t(w))
    for want in (rmsnorm_2d(jnp.asarray(x), jnp.asarray(w), block_rows=block_rows, interpret=True),
                 jax_rmsnorm_ref(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    # bf16 in, bf16 out: both round the same fp32 result once.
    xb = _t(x).to(torch.bfloat16)
    got_b = rmsnorm(xb, _t(w))
    assert got_b.dtype == torch.bfloat16
    want_b = rmsnorm_2d(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(w),
                        block_rows=block_rows, interpret=True)
    np.testing.assert_allclose(got_b.float().numpy(), np.asarray(want_b, np.float32),
                               rtol=2**-7, atol=1e-6)
    # Any rank: the trailing dim is normalized.
    x3 = _t(x[: R - R % 3].reshape(3, -1, D))
    torch.testing.assert_close(rmsnorm(x3, _t(w)), rmsnorm_ref(x3, _t(w)), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Model pieces and the model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair():
    """(jax model, jax params, port model, port params, numpy tree) on one
    set of fp32 smoke weights; the zero-initialized biases get random
    values so their paths are exercised."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32", param_dtype="float32")
    jmodel = jax_build_model(jcfg)
    tree = jax.tree.map(np.asarray, jax_init(jmodel.template, jax.random.PRNGKey(0), "float32"))
    rng = np.random.default_rng(1)
    p = tree["classes"]["c0"]["ssm"]
    for name in ("conv_b", "dt_bias"):
        p[name] = (0.1 * rng.standard_normal(p[name].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jfns = types.SimpleNamespace(
        prefill=jax.jit(jmodel.prefill, static_argnums=2),
        decode_step=jax.jit(jmodel.decode_step),
        decode_batch=jax.jit(jmodel.decode_batch),
        cfg=jcfg,
    )
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", param_dtype="float32")
    return jfns, jparams, build_model(tcfg), params_from_numpy(tree, device="cpu"), tree


def _layer0(tree):
    return {k: v[0] for k, v in tree["classes"]["c0"]["ssm"].items()}


def test_config_and_template_match_jax():
    from repro.configs import get_config as jax_get_config

    jmodel = jax_build_model(jax_get_config(ARCH))
    tmodel = build_model(get_config(ARCH))
    jleaves = jax.tree_util.tree_leaves_with_path(jmodel.template)
    tleaves = []

    def walk(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            tleaves.append((path, t))

    walk(tmodel.template)
    assert len(jleaves) == len(tleaves)
    by_path = {tuple(k.key for k in p): s for p, s in jleaves}
    for path, spec in tleaves:
        j = by_path[path]
        assert (spec.shape, spec.init, spec.initializer_std()) == (
            tuple(j.shape), j.init, j.initializer_std()), path
    from repro.models import count_params as jax_count_params

    n = count_params(tmodel.template)
    assert n == jax_count_params(jmodel.template) and round(n / 1e9, 3) == 7.006
    assert get_config(ARCH).dt_rank_actual == 256


def test_causal_conv_matches_jax():
    _, _, tmodel, _, tree = _pair()
    p = _layer0(tree)
    rng = np.random.default_rng(5)
    for S in (1, 2, 13):
        x = rng.standard_normal((2, S, tmodel.cfg.d_inner)).astype(np.float32)
        want = jax_ssm._causal_conv(jnp.asarray(x), jnp.asarray(p["conv_w"]),
                                    jnp.asarray(p["conv_b"]), jnp.float32)
        got = ssm._causal_conv(_t(x), _t(p["conv_w"]), _t(p["conv_b"]), torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("S", [1, 2, 13])
def test_mamba_block_and_decode_step_match_jax(S):
    """Prefill of S tokens (S < K-1 left-pads the conv tail), then three
    decode steps from the prefill's state."""
    jfns, _, tmodel, _, tree = _pair()
    p = _layer0(tree)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tmodel.cfg.d_model)).astype(np.float32)
    j_out, (j_conv, j_h) = jax_ssm.mamba_block(jnp.asarray(x), jp, jfns.cfg)
    t_out, (t_conv, t_h) = ssm.mamba_block(_t(x), tp, tmodel.cfg)
    assert t_conv.shape == (2, tmodel.cfg.ssm_conv - 1, tmodel.cfg.d_inner)
    for got, want in ((t_out, j_out), (t_conv, j_conv), (t_h, j_h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    j_state, t_state = (j_conv, j_h), (t_conv, t_h)
    for _ in range(3):
        x1 = rng.standard_normal((2, 1, tmodel.cfg.d_model)).astype(np.float32)
        j_out, j_state = jax_ssm.mamba_decode_step(jnp.asarray(x1), jp, jfns.cfg, j_state)
        t_out, t_state = ssm.mamba_decode_step(_t(x1), tp, tmodel.cfg, t_state)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **BLOCK_TOL)
        for got, want in zip(t_state, j_state):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=MODEL_ATOL, rtol=0)


def test_prefill_and_decode_match_jax():
    jfns, jparams, tmodel, tparams, _ = _pair()
    rng = np.random.default_rng(7)
    V = tmodel.cfg.vocab_size
    toks = rng.integers(0, V, size=(2, 9)).astype(np.int32)
    j_logits, j_cache = jfns.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32)
    t_logits, t_cache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 32)
    assert t_logits.shape == (2, 1, V)
    assert set(t_cache["c0"]) == {"conv", "ssm"} and t_cache["c0"]["ssm"].dtype == torch.float32
    _close(t_logits, j_logits)
    for name in ("conv", "ssm"):
        assert t_cache["c0"][name].shape == j_cache["c0"][name].shape
        _close(t_cache["c0"][name], j_cache["c0"][name])
    assert t_cache["len"].tolist() == [9, 9]
    for _ in range(3):
        nxt = rng.integers(0, V, size=(2, 1)).astype(np.int32)
        j_logits, j_cache = jfns.decode_step(jparams, jnp.asarray(nxt), j_cache)
        t_logits, t_cache = tmodel.decode_step(tparams, torch.from_numpy(nxt), t_cache)
        _close(t_logits, j_logits)
    for name in ("conv", "ssm"):
        _close(t_cache["c0"][name], j_cache["c0"][name])
    assert t_cache["len"].tolist() == [int(j_cache["len"])] * 2


def test_batched_decode_ragged_lanes_matches_jax():
    """Per-lane states in one call vs JAX's vmapped decode_batch over
    slot-stacked per-request caches; a call over a subset of lanes leaves
    the other lanes' conv / SSM state and lengths untouched."""
    jfns, jparams, tmodel, tparams, _ = _pair()
    rng = np.random.default_rng(11)
    V = tmodel.cfg.vocab_size
    caches = []
    for L in (3, 10, 1, 7):
        prompt = rng.integers(0, V, size=(1, L)).astype(np.int32)
        caches.append(jfns.prefill(jparams, {"tokens": jnp.asarray(prompt)}, 24)[1])
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
    nxt = rng.integers(0, V, size=(4, 1)).astype(np.int32)
    j_logits, j_new = jfns.decode_batch(jparams, jnp.asarray(nxt)[:, None], stacked)

    t_cache = cache_from_numpy(stacked, device="cpu")
    assert t_cache["len"].tolist() == [3, 10, 1, 7]
    t_logits = tmodel.decode_batch(tparams, torch.from_numpy(nxt), t_cache, torch.arange(4))
    _close(t_logits, np.asarray(j_logits)[:, 0])
    got = cache_to_numpy(t_cache)
    np.testing.assert_array_equal(got["len"], np.asarray(j_new["len"]))
    for name in ("conv", "ssm"):
        _close(got["c0"][name], j_new["c0"][name])

    sub = cache_from_numpy(stacked, device="cpu")
    lanes = torch.tensor([0, 2])
    sub_logits = tmodel.decode_batch(tparams, torch.from_numpy(nxt), sub, lanes)
    torch.testing.assert_close(sub_logits[lanes], t_logits[lanes], rtol=0, atol=1e-6)
    assert sub["len"].tolist() == [4, 10, 2, 7]
    before = cache_from_numpy(stacked, device="cpu")
    for lane in (1, 3):
        for name in ("conv", "ssm"):
            assert torch.equal(sub["c0"][name][:, lane], before["c0"][name][:, lane])
    for lane in (0, 2):
        for name in ("conv", "ssm"):
            assert torch.equal(sub["c0"][name][:, lane], t_cache["c0"][name][:, lane])


@pytest.mark.parametrize("G", [2, 3])
def test_partitioned_stages_equal_whole_model(G):
    _, _, tmodel, tparams, _ = _pair()
    rng = np.random.default_rng(G)
    toks = torch.from_numpy(rng.integers(0, tmodel.cfg.vocab_size, size=(2, 6)))
    whole_logits, whole_cache = tmodel.prefill(tparams, {"tokens": toks}, 16)
    stages = partition_model(tmodel.cfg, tparams, G)
    assert "tok" in stages[-1][1]["embed"]  # tied embedding on the last stage
    assert sum(p["classes"]["c0"]["ssm"]["A_log"].shape[0] for _, p in stages) == 2
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


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jfns, jparams, tmodel, tparams, _ = _pair()
    return (jax_build_model(jfns.cfg), jparams), (tmodel, tparams)


@pytest.mark.parametrize("async_depth", [0, 2])
def test_server_matches_reference(weights, async_depth):
    (jmodel, jparams), (tmodel, tparams) = weights
    ref = JaxPipelineServer(jmodel, jparams, async_depth=async_depth, **SERVER_KW)
    ours = PipelineServer(tmodel, tparams, async_depth=async_depth, device="cpu", **SERVER_KW)
    ref_reqs, our_reqs = _recording(ref), _recording(ours)
    ref.run(30, arrival_p=0.5)
    ours.run(30, arrival_p=0.5)
    _assert_same_run(ref, ref_reqs, ours, our_reqs)
    assert ours.stats.tokens_generated > 0 and ours.stats.completed_jobs > 0


def test_server_matches_reference_through_fail_and_recover(weights):
    (jmodel, jparams), (tmodel, tparams) = weights
    ref = JaxPipelineServer(jmodel, jparams, **SERVER_KW)
    ours = PipelineServer(tmodel, tparams, device="cpu", **SERVER_KW)
    events = {10: lambda s: s.fail_replica(0, 0), 20: lambda s: s.recover_replica(0, 0)}
    ref_reqs, our_reqs = _recording(ref), _recording(ours)
    _drive(ref, 30, events)
    _drive(ours, 30, events)
    _assert_same_run(ref, ref_reqs, ours, our_reqs)
    assert ours.stats.rerouted_stages > 0  # the failure really moved work


def test_server_keeps_ssm_state_in_its_cache(weights):
    _, (tmodel, tparams) = weights
    ours = PipelineServer(tmodel, tparams, device="cpu", **SERVER_KW)
    ours.run(5, arrival_p=1.0)
    for (cache,) in ours._caches.values():  # one tree per mesh position; one without a mesh
        assert set(cache["c0"]) == {"conv", "ssm"}
        assert cache["c0"]["ssm"].dtype == torch.float32
        assert cache["c0"]["ssm"].device == torch.device("cpu")


def test_unsupported_serving_modes_raise_as_in_jax(weights):
    """Mamba serves from the dense slot cache only: paging and chunked
    prefill raise ValueError on both sides (the port checks chunk support
    before its missing dense chunk path)."""
    (jmodel, jparams), (tmodel, tparams) = weights
    for kw in (dict(paged=True), dict(prefill_chunk=4), dict(paged=True, prefill_chunk=4)):
        with pytest.raises(ValueError, match="uniform full attention"):
            JaxPipelineServer(jmodel, jparams, **SERVER_KW, **kw)
        with pytest.raises(ValueError, match="uniform full attention"):
            PipelineServer(tmodel, tparams, device="cpu", **SERVER_KW, **kw)


def test_cli_serves_falcon_mamba_like_the_jax_cli(capsys, monkeypatch):
    """The schedule does not depend on the weights, so the summary lines
    are equal although the two CLIs draw their random weights differently."""
    from repro.launch import serve as jax_serve_cli

    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--slots", "10"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--slots", "10"])
    jax_serve_cli.main()
    assert capsys.readouterr().out.strip().splitlines()[-1] == line
    assert line.startswith("policy=adaptive: submitted=") and "tokens=" in line


def test_cpu_wrappers_launch_no_kernel():
    rng = np.random.default_rng(0)
    x, dt, Bm, Cm, A, h0 = _scan_inputs(rng, 1, 5, 8, 4, True)
    before = selective_scan.launches, rmsnorm.launches
    selective_scan(_t(x), _t(dt), _t(Bm), _t(Cm), _t(A), _t(h0))
    rmsnorm(_t(x), _t(np.ones(8, np.float32)))
    _, _, tmodel, tparams, _ = _pair()
    tmodel.prefill(tparams, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, 8)
    assert (selective_scan.launches, rmsnorm.launches) == before
    # A meta tensor (the dry run's) gets meta outputs of the kernels' shapes
    # and launches nothing; any device but cpu, cuda and meta still raises.
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    y, h = selective_scan(meta(1, 5, 8), meta(1, 5, 8), meta(1, 5, 4), meta(1, 5, 4), meta(8, 4))
    assert (y.shape, h.shape, y.device.type) == ((1, 5, 8), (1, 8, 4), "meta")
    assert rmsnorm(meta(1, 5, 8), meta(8)).shape == (1, 5, 8)
    assert (selective_scan.launches, rmsnorm.launches) == before
    elsewhere = types.SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(ValueError, match="unsupported device"):
        selective_scan(elsewhere, elsewhere, elsewhere, elsewhere, elsewhere)
    with pytest.raises(ValueError, match="unsupported device"):
        rmsnorm(elsewhere, elsewhere)
