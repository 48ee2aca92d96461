"""The port's paged serving path against the JAX package's, on the CPU.

* The plain paged-decode and paged-prefill versions against the JAX
  Pallas kernels (interpret mode) and the JAX oracles on shuffled pools,
  ragged lengths and offsets, GQA, a window and int8 pages, at 3e-5
  (``tests/test_paged_prefill.py``'s tolerance: fp32 on both sides, other
  summation orders).
* ``quantize_kv``: the same int8 values, scales within 1 ulp.
* ``PagePool`` / ``PagedKVCache`` through one random operation sequence on
  both sides: equal block tables and free lists. Contexts of length 0 are
  not compared: the port keeps zero pages there (ROADMAP Queue 3).
* ``decode_step_paged`` / ``prefill_chunk_paged`` on the same pools:
  logits within 1e-4, pools within 1e-5, int8 pool values equal.
* The paged ``PipelineServer`` against the JAX one on the same fp32 smoke
  weights and seed: the same token streams and equal ``ServerStats``,
  with and without chunked prefill, at async depths 0 and 2, with int8
  pages, under preemption, and through a fail/recover.
"""

import dataclasses

import jax
import jax.extend.core as _jax_core

# The reference serving stack imports jax.core.{Literal, ClosedJaxpr,
# Jaxpr}, which jax 0.9 moved to jax.extend.core. Restore the old names
# before importing it (as tests/test_torch_serving.py does).
for _name in ("Literal", "ClosedJaxpr", "Jaxpr"):
    if not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(_jax_core, _name))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from conftest import tiny_model  # noqa: E402
from repro.kernels.decode_attention import gather_pages as jax_gather_pages  # noqa: E402
from repro.kernels.decode_attention import paged_decode_attention as jax_paged_decode  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention_ref as jax_paged_decode_ref,
)
from repro.kernels.decode_attention import paged_prefill_attention as jax_paged_prefill_ref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    paged_prefill_attention_pallas as jax_paged_prefill,
)
from repro.kernels.decode_attention import quantize_kv as jax_quantize_kv  # noqa: E402
from repro.serving import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro.serving import PipelineServer as JaxPipelineServer  # noqa: E402
from repro.serving.cache import kv_page_bytes as jax_kv_page_bytes  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    gather_pages,
    paged_decode_attention,
    paged_prefill_attention,
    quantize_kv,
)
from repro_torch.kernels.decode_attention.ops import MIN_TILES_PER_WARP, split_tiles  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import PipelineServer  # noqa: E402
from repro_torch.serving.cache import PagedKVCache, PageError, kv_page_bytes  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)
# Two stages: the smoke model has two layers, and the JAX server refuses
# a paged stage without layers (the port serves it: see the CLI test).
SERVER_KW = dict(n_groups=2, n_replicas=3, max_len=128, max_batch=4, seed=0, paged=True)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _pool(rng, B, NB, page, KV, D, spare=3, quant=False):
    """A shuffled pool: lane b's logical block j is page bt[b, j]; other
    pages hold garbage. int8 pools come with their per-row scales."""
    P = B * NB + spare
    bt = rng.permutation(P)[: B * NB].reshape(B, NB).astype(np.int32)
    k = rng.standard_normal((P, page, KV, D)).astype(np.float32)
    v = rng.standard_normal((P, page, KV, D)).astype(np.float32)
    if not quant:
        return bt, k, v, None, None
    qk, ks = jax_quantize_kv(jnp.asarray(k))
    qv, vs = jax_quantize_kv(jnp.asarray(v))
    return bt, np.asarray(qk), np.asarray(qv), np.asarray(ks), np.asarray(vs)


def _opt(x):
    return None if x is None else jnp.asarray(x)


def _topt(x):
    return None if x is None else _t(x)


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels and the JAX oracles
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # B, page, H, KV, D, lengths, window, int8
    (3, 8, 4, 4, 32, [1, 17, 40], None, False),  # MHA, ragged lengths
    (4, 4, 8, 2, 16, [5, 16, 9, 13], None, False),  # GQA G=4
    (2, 16, 6, 3, 32, [64, 23], 10, False),  # window
    (3, 8, 8, 1, 32, [24, 3, 11], None, True),  # MQA, int8 pages
    (2, 4, 4, 2, 16, [12, 7], 5, True),  # int8 + window
]


@pytest.mark.parametrize("B,page,H,KV,D,lengths,window,int8", DECODE_CASES)
def test_paged_decode_plain_matches_pallas_and_oracle(B, page, H, KV, D, lengths, window, int8):
    rng = np.random.default_rng(B * 100 + page + H)
    NB = -(-max(lengths) // page)
    bt, k, v, ks, vs = _pool(rng, B, NB, page, KV, D, quant=int8)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), jnp.asarray(lens))
    pallas = jax_paged_decode(*jargs, window=window, k_scales=_opt(ks), v_scales=_opt(vs),
                              interpret=True)
    oracle = jax_paged_decode_ref(*jargs, window=window, k_scales=_opt(ks), v_scales=_opt(vs))
    got = paged_decode_attention(_t(q), _t(k), _t(v), _t(bt), _t(lens), window=window,
                                 k_scales=_topt(ks), v_scales=_topt(vs)).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


PREFILL_CASES = [
    # B, C, page, H, KV, D, offsets, int8
    (3, 5, 4, 6, 2, 8, [0, 7, 19], False),  # GQA G=3, ragged offsets
    (2, 8, 8, 4, 4, 16, [0, 13], False),  # chunk crossing pages
    (2, 1, 4, 4, 4, 16, [0, 9], False),  # one-token chunk
    (2, 4, 8, 4, 1, 8, [0, 5], True),  # MQA, int8 pages
    (1, 20, 4, 4, 2, 16, [0], True),  # int8 whole prompt (offset 0)
    # Chunks straddling page edges and the bf16 kernel's 64-row tile edge.
    (2, 37, 16, 4, 2, 16, [5, 59], False),
    (2, 37, 16, 4, 2, 16, [5, 59], True),
]


@pytest.mark.parametrize("B,C,page,H,KV,D,offsets,int8", PREFILL_CASES)
def test_paged_prefill_plain_matches_pallas_and_oracle(B, C, page, H, KV, D, offsets, int8):
    rng = np.random.default_rng(B * 100 + C + page)
    NB = -(-(max(offsets) + C) // page)
    bt, k, v, ks, vs = _pool(rng, B, NB, page, KV, D, quant=int8)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    offs = np.asarray(offsets, np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), jnp.asarray(offs))
    pallas = jax_paged_prefill(*jargs, k_scales=_opt(ks), v_scales=_opt(vs), interpret=True)
    oracle = jax_paged_prefill_ref(*jargs, k_scales=_opt(ks), v_scales=_opt(vs))
    got = paged_prefill_attention(_t(q), _t(k), _t(v), _t(bt), _t(offs),
                                  k_scales=_topt(ks), v_scales=_topt(vs)).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    assert np.isfinite(got).all()


def test_gather_pages_matches_reference():
    rng = np.random.default_rng(3)
    bt, k, _, ks, _ = _pool(rng, 3, 4, 4, 2, 8, quant=True)
    want = jax_gather_pages(jnp.asarray(k), jnp.asarray(bt), jnp.asarray(ks))
    np.testing.assert_array_equal(gather_pages(_t(k), _t(bt), _t(ks)).numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(4, 5, 2, 16), (3, 1, 8)])
def test_quantize_kv_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10, size=shape[:-2] + (1, 1)))
    x = x.astype(np.float32)
    x[0] = 0.0  # all-zero rows: scale 1, values 0
    wq, ws = jax_quantize_kv(jnp.asarray(x))
    gq, gs = quantize_kv(_t(x))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_max_ulp(gs.numpy(), np.asarray(ws), maxulp=1)
    assert (gs.numpy()[0] == 1.0).all()


# The launch shape's constants as csrc/paged_decode_attention.cu exports
# them (kWarps, kMaxChunks of csrc/split_decode.cuh); the GPU tests read
# them from the build.
SHAPE = dict(warps=8, max_chunks=8)


def test_split_pages_chunks_whole_pages():
    # Serving shape (8 lanes x 32 KV heads, 16 pages): one chunk, two pages
    # for each of a block's warps.
    assert split_tiles(8 * 32, 16, resident=2 * 132, **SHAPE) == (16, 1)
    # The long GQA case (4 lanes x 8 KV heads, 256 pages): a full cluster of
    # 8 chunks where the card holds them, 4 where it holds one block per SM.
    assert split_tiles(4 * 8, 256, resident=8 * 132, **SHAPE) == (32, 8)
    assert split_tiles(4 * 8, 256, resident=132, **SHAPE) == (64, 4)
    assert split_tiles(1, 3, resident=132, **SHAPE) == (3, 1)
    # Four-warp blocks split a 16-page row in two; a cluster cap of 2 stops
    # the long case at two chunks.
    assert split_tiles(8 * 32, 16, resident=8 * 132, warps=4, max_chunks=8) == (8, 2)
    assert split_tiles(4 * 8, 256, resident=8 * 132, warps=8, max_chunks=2) == (128, 2)


@pytest.mark.parametrize(
    "blocks,NB,resident",
    [
        (256, 16, 4 * 132),  # stablelm paged serving: 8 lanes x 32 KV heads, 16 pages
        (32, 256, 2 * 132),  # the long GQA case: 4 lanes x 8 KV heads, 4096 rows
        (1, 16384, 132),  # one lane at the widest table the prefill kernel takes
        (8192, 16, 8 * 132),  # more lanes x heads than the card holds: one chunk
        (300, 17, 8 * 132),  # a ragged row under the cap
        (1, 20, 132),  # fewer pages than two chunks of two pages per warp
        (1, 0, 132),  # an empty table
        (64, 64, 1),  # one resident block
    ],
)
def test_split_pages_covers_the_row_within_its_limits(blocks, NB, resident):
    """Whole pages that cover the widest row, at most one cluster of
    chunks, no split that leaves a warp fewer than MIN_TILES_PER_WARP
    pages, and no more chunks than keep the grid resident at once."""
    per_chunk, n_chunks = split_tiles(blocks, NB, resident, **SHAPE)
    assert isinstance(per_chunk, int) and isinstance(n_chunks, int)
    assert per_chunk >= 1 and 1 <= n_chunks <= SHAPE["max_chunks"]
    assert per_chunk * n_chunks >= NB
    assert per_chunk * (n_chunks - 1) < max(NB, 1)  # no chunk is wholly empty
    assert n_chunks == 1 or per_chunk >= SHAPE["warps"] * MIN_TILES_PER_WARP
    assert n_chunks == 1 or blocks * n_chunks <= resident


def test_kv_page_bytes_matches_reference():
    for dtype in ("float32", "int8"):
        assert kv_page_bytes(16, 8, 64, 24, dtype) == jax_kv_page_bytes(16, 8, 64, 24, dtype)
    # numpy has no bfloat16 for the reference to name: 2 bytes per entry.
    assert kv_page_bytes(16, 8, 64, 24, "bfloat16") == 2 * 24 * 16 * 8 * 64 * 2


def test_cpu_wrappers_launch_no_kernel():
    rng = np.random.default_rng(0)
    bt, k, v, _, _ = _pool(rng, 2, 2, 4, 2, 64)
    q = _t(rng.standard_normal((2, 3, 4, 64)).astype(np.float32))
    before = paged_decode_attention.launches, paged_prefill_attention.launches
    paged_decode_attention(q[:, :1], _t(k), _t(v), _t(bt), torch.tensor([3, 8], dtype=torch.int32))
    paged_prefill_attention(q, _t(k), _t(v), _t(bt), torch.tensor([0, 5], dtype=torch.int32))
    assert (paged_decode_attention.launches, paged_prefill_attention.launches) == before


# ---------------------------------------------------------------------------
# Page accounting
# ---------------------------------------------------------------------------

def _same_manager(ours: PagedKVCache, ref) -> None:
    np.testing.assert_array_equal(ours.block_table, ref.block_table)
    assert ours.pool._free == ref.pool._free
    assert ours.pages == ref.pages
    assert ours.slots == ref.slots
    np.testing.assert_array_equal(ours.lengths, ref.lengths)
    assert ours.capacity_weight() == ref.capacity_weight()


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_cache_lifecycle_matches_reference(seed):
    """One random sequence of reserve / try_extend / rollback / release on
    both managers (never a try_extend to length 0: Queue 3)."""
    rng = np.random.default_rng(seed)
    args = (4, 40, 4, 12)  # slots, max_len, page, pages
    ours = PagedKVCache(*args, table_buffers=3)
    ref = JaxPagedKVCache(*args, table_buffers=3)
    owned: dict[int, int] = {}
    for rid in range(300):
        op = rng.integers(0, 4)
        if op == 0 or not owned:
            length = int(rng.integers(0, 30))
            assert ours.can_reserve(length) == ref.can_reserve(length)
            if ref.can_reserve(length):
                slot = ref.reserve(rid, length)
                assert ours.reserve(rid, length) == slot
                ours.lengths[slot] = ref.lengths[slot] = length
                owned[rid] = slot
        else:
            victim = int(rng.choice(sorted(owned)))
            slot = owned[victim]
            if op == 1:
                length = int(rng.integers(1, 40))
                assert ours.try_extend(victim, slot, length) == ref.try_extend(victim, slot, length)
                ours.lengths[slot] = ref.lengths[slot] = max(int(ref.lengths[slot]), length)
            elif op == 2:
                n = int(rng.integers(0, ref.lengths[slot] + 1))
                ours.rollback(victim, slot, n), ref.rollback(victim, slot, n)
            else:
                owned.pop(victim)
                ours.release(victim, slot), ref.release(victim, slot)
        if rng.uniform() < 0.3:
            np.testing.assert_array_equal(ours.device_block_table().numpy(),
                                          np.asarray(ref.device_block_table()))
        _same_manager(ours, ref)
        ours.check_conservation()


def test_paged_cache_zero_length_holds_zero_pages():
    cache = PagedKVCache(2, 16, 4, 4)
    slot = cache.reserve(7, 0)
    assert cache.try_extend(7, slot, 0) and cache.held(7) == 0
    assert cache.try_extend(7, slot, 5) and cache.held(7) == 2
    cache.lengths[slot] = 5
    cache.rollback(7, slot, 5)
    assert cache.held(7) == 0
    with pytest.raises(PageError, match="block-table row"):
        cache.try_extend(7, slot, 17)
    cache.release(7, slot)
    cache.check_conservation()


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """The fp32 stablelm smoke model on both sides, one set of weights."""
    _, jmodel, jparams = tiny_model("stablelm-1.6b")
    cfg = dataclasses.replace(
        get_smoke_config("stablelm-1.6b"), dtype="float32", param_dtype="float32"
    )
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jmodel, jparams), (build_model(cfg), tparams)


def _model_pools(rng, cfg, P, page, int8):
    shape = (cfg.n_layers, P + 1, page, cfg.n_kv_heads, cfg.head_dim)
    k = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    if not int8:
        return {"k": k, "v": v}
    qk, ks = jax_quantize_kv(jnp.asarray(k))
    qv, vs = jax_quantize_kv(jnp.asarray(v))
    return {"k": np.asarray(qk), "v": np.asarray(qv),
            "k_scale": np.asarray(ks), "v_scale": np.asarray(vs)}


def _check_pools(got: dict, want: dict) -> None:
    for name, w in want.items():
        g = got[name].numpy()
        w = np.asarray(w)
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_model_steps_match_jax(weights, int8):
    """A chunk over ragged lanes (one masked), then two decode steps, on
    the same pools and block tables."""
    (jmodel, jparams), (tmodel, tparams) = weights
    cfg = tmodel.cfg
    rng = np.random.default_rng(5 + int8)
    W, page, NB, C = 4, 4, 5, 6
    P = W * NB + 2
    bt = rng.permutation(P)[: W * NB].reshape(W, NB).astype(np.int32)
    pools = _model_pools(rng, cfg, P, page, int8)
    jpools = {n: jnp.asarray(a) for n, a in pools.items()}
    tpools = {n: _t(a.copy()) for n, a in pools.items()}

    chunk = rng.integers(0, cfg.vocab_size, size=(W, C)).astype(np.int32)
    offs = np.asarray([0, 3, -1, 9], np.int32)
    valids = np.asarray([6, 4, 0, 2], np.int32)
    j_out, jpools = jax.jit(jmodel.prefill_chunk_paged)(
        jparams, jnp.asarray(chunk), jpools, jnp.asarray(offs), jnp.asarray(valids),
        jnp.asarray(bt),
    )
    t_out = tmodel.prefill_chunk_paged(tparams, _t(chunk), tpools, _t(offs), _t(valids), _t(bt))
    for w in range(W):
        np.testing.assert_allclose(t_out[w, : valids[w]].numpy(),
                                   np.asarray(j_out)[w, : valids[w]], atol=1e-4, rtol=0)
    # The scratch page (index P) holds racing writes of masked lanes.
    _check_pools({n: t[:, :P] for n, t in tpools.items()},
                 {n: np.asarray(a)[:, :P] for n, a in jpools.items()})

    lens = offs + valids
    lens[2] = -1  # masked lane
    decode = jax.jit(jmodel.decode_paged)
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab_size, size=(W, 1)).astype(np.int32)
        j_out, jpools = decode(jparams, jnp.asarray(tok), jpools, jnp.asarray(lens),
                               jnp.asarray(bt))
        t_out = tmodel.decode_paged(tparams, _t(tok), tpools, _t(lens), _t(bt))
        live = lens >= 0
        np.testing.assert_allclose(t_out.numpy()[live], np.asarray(j_out)[live],
                                   atol=1e-4, rtol=0)
        lens[live] += 1
    _check_pools({n: t[:, :P] for n, t in tpools.items()},
                 {n: np.asarray(a)[:, :P] for n, a in jpools.items()})


# ---------------------------------------------------------------------------
# Paged server against the reference server
# ---------------------------------------------------------------------------

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


def _drive(server, n_slots, events):
    """``PipelineServer.run``'s loop with replica events after given slots."""
    for t in range(n_slots):
        if server._rng.uniform() < 0.5:
            prompt = server._rng.integers(0, server.cfg.vocab_size, size=8)
            server.submit(prompt, n_tokens=4)
        server.step()
        if t in events:
            events[t](server)


def _run_pair(weights, n_slots=30, events=None, **kw):
    (jmodel, jparams), (tmodel, tparams) = weights
    ref = JaxPipelineServer(jmodel, jparams, **{**SERVER_KW, **kw})
    ours = PipelineServer(tmodel, tparams, device="cpu", **{**SERVER_KW, **kw})
    ref_reqs, our_reqs = _recording(ref), _recording(ours)
    _drive(ref, n_slots, events or {})
    _drive(ours, n_slots, events or {})
    assert len(our_reqs) == len(ref_reqs)
    for got, want in zip(our_reqs, ref_reqs):
        assert (got is None) == (want is None)
        if want is not None:
            assert got.generated == want.generated, got.rid
            assert (got.done, got.dropped) == (want.done, want.dropped)
    for name, value in dataclasses.asdict(ours.stats).items():
        if name == "energy_charged":
            assert value == pytest.approx(ref.stats.energy_charged, abs=1e-9)
        else:
            assert value == getattr(ref.stats, name), name
    for key, mgr in ours.managers.items():
        mgr.check_conservation()
        np.testing.assert_array_equal(mgr.block_table, ref.managers[key].block_table)
    return ours


@pytest.mark.parametrize("prefill_chunk", [None, 4])
@pytest.mark.parametrize("async_depth", [0, 2])
def test_paged_server_matches_reference(weights, prefill_chunk, async_depth):
    ours = _run_pair(weights, prefill_chunk=prefill_chunk, async_depth=async_depth)
    st = ours.stats
    assert st.tokens_generated > 0
    assert (st.chunk_prefill_calls > 0) == (prefill_chunk is not None)
    # Readbacks happen at commit from depth 1 on, at dispatch at depth 0.
    assert (ours.host_readback.counts["dispatch"] == 0) == (async_depth > 0)


@pytest.mark.parametrize("prefill_chunk", [None, 4])
def test_paged_int8_server_matches_reference(weights, prefill_chunk):
    ours = _run_pair(weights, kv_dtype="int8", prefill_chunk=prefill_chunk)
    (pools,) = ours._caches[(0, 0)]  # one tree per mesh position; one without a mesh
    assert pools["k"].dtype == torch.int8 and pools["k_scale"].dtype == torch.float32
    assert ours.stats.tokens_generated > 0


def test_paged_server_matches_reference_under_preemption(weights):
    ours = _run_pair(weights, page_size=4, max_pages=6, prefill_chunk=3)
    assert ours.stats.preempted_jobs > 0


def test_paged_server_matches_reference_through_fail_and_recover(weights):
    events = {10: lambda s: s.fail_replica(0, 0), 20: lambda s: s.recover_replica(0, 0)}
    ours = _run_pair(weights, events=events, prefill_chunk=4)
    assert ours.stats.rerouted_stages > 0


def test_paged_arguments_are_checked(weights):
    _, (tmodel, tparams) = weights
    with pytest.raises(ValueError, match="paged KV cache only"):
        PipelineServer(tmodel, tparams, device="cpu", kv_dtype="int8")
    with pytest.raises(ValueError, match="compute dtype or int8"):
        PipelineServer(tmodel, tparams, device="cpu", paged=True, n_groups=2, kv_dtype="float16")
    with pytest.raises(ValueError, match="positive"):
        PipelineServer(tmodel, tparams, device="cpu", paged=True, n_groups=2, prefill_chunk=0)
    # Chunked prefill over the dense cache is served too (tests/test_torch_chunked.py).
    dense = PipelineServer(tmodel, tparams, device="cpu", prefill_chunk=4)
    assert dense.prefill_chunk == 4 and not dense.paged
    server = PipelineServer(tmodel, tparams, device="cpu", paged=True, n_groups=2, max_len=64)
    assert server.max_pages == 4 * 4  # the dense reservation


def test_cli_paged_flags(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--paged", "--prefill-chunk", "4",
                    "--kv-dtype", "int8", "--slots", "20"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("policy=adaptive: submitted=")
    assert "preempted=" in line and "peak_active=" in line
    if not torch.cuda.is_available():  # the CLI runs on the card by default
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_cli.main(["--smoke", "--paged", "--slots", "2"])
