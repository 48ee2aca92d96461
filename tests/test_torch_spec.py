"""The port's speculative draft-verify serving against the JAX package's,
on the CPU.

* ``verify_step_paged`` against the JAX function on the same pools and
  block tables (outputs within 1e-4, pools within 1e-5, int8 pool values
  equal), and against sequential paged decode steps (the verify's row j
  is what plain decode gives after the first j + 1 inputs).
* ``DenseSlotCache.rollback`` / ``PagedKVCache.rollback`` through random
  operation sequences on both packages' managers: equal lengths, pages
  and block tables. The rollback-then-rewrite replay of the JAX property
  test, with the operations that make the JAX manager hold a page at
  length 0, holds under the port's zero-page choice.
* The speculative ``PipelineServer`` against the JAX one on the same fp32
  smoke weights and seed: the same token streams and equal
  ``ServerStats`` (spec counters and ``energy_charged`` included), for a
  self-draft at k = 1 and 4, async depths 0 and 2, compute-dtype and int8
  pages; for a draft with a smaller vocabulary than its target (the JAX
  draft is handed over under its target's vocabulary size, which the
  JAX engine checks; its gather clamps the ids past its vocabulary as the
  port's embedding does); for the registry pairs qwen2.5 / granite ->
  stablelm; through failovers and under preemption. Two stages unless
  a trace says otherwise: the smoke models have two layers and the JAX
  server refuses a paged stage without layers.
* Host readbacks: none in the dispatch phase at async depth 2, at most
  3 per step at commit (the JAX engine's ``per_step_budget.spec``).
* The CLI's ``--spec-draft`` / ``--spec-k``.
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
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.decode_attention import quantize_kv as jax_quantize_kv  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import init_from_template as jax_init  # noqa: E402
from repro.serving import DenseSlotCache as JaxDenseSlotCache  # noqa: E402
from repro.serving import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro.serving import PipelineServer as JaxPipelineServer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.registry import default_draft_for  # noqa: E402
from repro_torch.serving import DenseSlotCache, PipelineServer  # noqa: E402
from repro_torch.serving.cache import PagedKVCache, PageError  # noqa: E402

SERVER_KW = dict(n_groups=2, n_replicas=3, max_len=128, max_batch=4, seed=0, paged=True)


def _pair(arch, vocab=None, seed=0):
    """The fp32 smoke model of ``arch`` (vocabulary ``vocab`` if given) on
    both sides, one set of weights drawn from ``seed``."""
    over = dict(dtype="float32", param_dtype="float32")
    if vocab is not None:
        over["vocab_size"] = vocab
    jmodel = jax_build_model(dataclasses.replace(jax_smoke_config(arch), **over))
    jparams = jax_init(jmodel.template, jax.random.PRNGKey(seed), "float32")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tmodel = build_model(dataclasses.replace(get_smoke_config(arch), **over))
    return (jmodel, jparams), (tmodel, tparams)


@pytest.fixture(scope="module")
def weights():
    _, jmodel, jparams = tiny_model("stablelm-1.6b")
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32",
                              param_dtype="float32")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jmodel, jparams), (build_model(cfg), tparams)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Verify step
# ---------------------------------------------------------------------------

def _pools(rng, cfg, P, page, int8):
    shape = (cfg.n_layers, P + 1, page, cfg.n_kv_heads, cfg.head_dim)
    k = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    if not int8:
        return {"k": k, "v": v}
    qk, ks = jax_quantize_kv(jnp.asarray(k))
    qv, vs = jax_quantize_kv(jnp.asarray(v))
    return {"k": np.asarray(qk), "v": np.asarray(qv),
            "k_scale": np.asarray(ks), "v_scale": np.asarray(vs)}


@pytest.mark.parametrize("int8", [False, True])
def test_verify_step_paged_matches_jax_and_sequential_decode(weights, int8):
    """k = 4: three lanes verify 5, 3 (one masked lane between) positions
    at offsets 3 and 9 of shuffled pools."""
    (jmodel, jparams), (tmodel, tparams) = weights
    cfg = tmodel.cfg
    rng = np.random.default_rng(8 + int8)
    W, page, NB, C = 3, 4, 5, 5
    P = W * NB + 2
    bt = rng.permutation(P)[: W * NB].reshape(W, NB).astype(np.int32)
    pools = _pools(rng, cfg, P, page, int8)
    chunk = rng.integers(0, cfg.vocab_size, size=(W, C)).astype(np.int32)
    offs = np.asarray([3, -1, 9], np.int32)
    valids = np.asarray([5, 0, 3], np.int32)
    j_out, j_pools = jax.jit(jmodel.verify_step_paged)(
        jparams, jnp.asarray(chunk), {n: jnp.asarray(a) for n, a in pools.items()},
        jnp.asarray(offs), jnp.asarray(valids), jnp.asarray(bt))
    t_pools = {n: _t(a.copy()) for n, a in pools.items()}
    t_out = tmodel.verify_step_paged(tparams, _t(chunk), t_pools, _t(offs), _t(valids), _t(bt))
    for w in (0, 2):
        np.testing.assert_allclose(t_out[w, : valids[w]].numpy(),
                                   np.asarray(j_out)[w, : valids[w]], atol=1e-4, rtol=0)
    for name, want in j_pools.items():  # the scratch page (P) holds racing writes
        got, want = t_pools[name][:, :P].numpy(), np.asarray(want)[:, :P]
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)
    # The same inputs one decode step at a time, on a fresh copy.
    seq_pools = {n: _t(a.copy()) for n, a in pools.items()}
    for j in range(C):
        lens = np.where(valids > j, offs + j, -1).astype(np.int32)
        out = tmodel.decode_paged(tparams, _t(chunk[:, j : j + 1]), seq_pools, _t(lens), _t(bt))
        for w in np.flatnonzero(lens >= 0):
            torch.testing.assert_close(out[w, 0], t_out[w, j], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Rollback
# ---------------------------------------------------------------------------

def _same_manager(ours, ref, paged: bool) -> None:
    assert ours.slots == ref.slots
    np.testing.assert_array_equal(ours.lengths, ref.lengths)
    assert ours.capacity_weight() == ref.capacity_weight()
    if paged:
        assert ours.pages == ref.pages
        np.testing.assert_array_equal(ours.block_table, ref.block_table)
        assert ours.pool._free == ref.pool._free


@pytest.mark.parametrize("paged,seed", [(False, 0), (True, 0), (True, 1)])
def test_rollback_random_ops_match_reference(paged, seed):
    """``tests/test_spec_decode.py``'s rollback fuzzer on both packages'
    managers: reserve, try_extend (never to length 0, where the port
    holds no page), rollback, release; an over-rollback raises on both."""
    if paged:
        ours, ref = PagedKVCache(3, 64, 4, 20), JaxPagedKVCache(3, 64, 4, 20)
    else:
        ours, ref = DenseSlotCache(3, 64), JaxDenseSlotCache(3, 64)
    rng = np.random.default_rng(seed)
    live: dict[int, int] = {}
    next_rid = 0
    for _ in range(400):
        u = rng.uniform()
        if u < 0.2 or not live:
            length = int(rng.integers(0, 33))
            assert ours.can_reserve(length) == ref.can_reserve(length)
            if ref.can_reserve(length):
                slot = ref.reserve(next_rid, length)
                assert ours.reserve(next_rid, length) == slot
                ours.lengths[slot] = ref.lengths[slot] = length
                live[next_rid] = slot
                next_rid += 1
        else:
            rid = int(rng.choice(sorted(live)))
            slot = live[rid]
            if u < 0.5:
                target = int(rng.integers(1, 49))
                got = ours.try_extend(rid, slot, target)
                assert got == ref.try_extend(rid, slot, target)
                if got:
                    ours.lengths[slot] = ref.lengths[slot] = max(int(ref.lengths[slot]), target)
            elif u < 0.85:
                n = int(rng.integers(0, int(ref.lengths[slot]) + 1))
                ours.rollback(rid, slot, n), ref.rollback(rid, slot, n)
                if paged and n > 0:
                    length = int(ours.lengths[slot])
                    assert ours.held(rid) == (ours.pool.blocks_for(length) if length else 0)
            else:
                ours.release(rid, live.pop(rid)), ref.release(rid, slot)
        _same_manager(ours, ref, paged)
        ours.check_conservation()
        if live:
            rid = next(iter(live))
            too_far = int(ours.lengths[live[rid]]) + 1
            with pytest.raises(PageError):
                ours.rollback(rid, live[rid], too_far)
            with pytest.raises(Exception):
                ref.rollback(rid, live[rid], too_far)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ops", [
    [("reserve", 0, 0), ("reserve", 0, 0)],
    [("extend", 0, 5), ("rollback", 0, 5), ("extend", 0, 0), ("extend", 0, 13)],
])
def test_rollback_then_rewrite_holds_exact_pages(ops, seed):
    """``tests/test_property_spec.py::test_rollback_then_rewrite_is_exact``
    replayed on the port's manager: after every rollback or re-extend the
    context holds exactly the pages its length needs, none at length 0."""
    mgr = PagedKVCache(2, 48, 8, 12)
    rng = np.random.default_rng(seed)
    slot = mgr.reserve(0, 0)
    length = 0
    for _, _, amount in ops:
        if rng.uniform() < 0.5:
            target = min(48, length + amount % 9)
            if mgr.try_extend(0, slot, target):
                length = max(length, target)
                mgr.lengths[slot] = length
        else:
            n = amount % (length + 1)
            mgr.rollback(0, slot, n)
            length -= n
        assert int(mgr.lengths[slot]) == length
        assert mgr.held(0) == (mgr.pool.blocks_for(length) if length > 0 else 0)
        mgr.check_conservation()


# ---------------------------------------------------------------------------
# Speculative server against the reference server
# ---------------------------------------------------------------------------

def _drive(server, n_slots, events, n_tokens=6, prompt_len=8):
    """``PipelineServer.run``'s loop with replica events after given
    slots; returns every request ``submit`` gave back."""
    reqs = []
    for t in range(n_slots):
        if server._rng.uniform() < 0.5:
            prompt = server._rng.integers(0, server.cfg.vocab_size, size=prompt_len)
            reqs.append(server.submit(prompt, n_tokens=n_tokens))
        server.step()
        if t in events:
            events[t](server)
    return reqs


def _jax_draft(jdraft, target_vocab):
    """The JAX engine refuses a draft whose vocabulary size differs from
    its target's; its entry points read their own config, so handing the
    model over under the target's size changes nothing else."""
    cfg = dataclasses.replace(jdraft.cfg, vocab_size=target_vocab)
    return dataclasses.replace(jdraft, cfg=cfg)


def _run_pair(target, draft, n_slots=30, events=None, trace=None, **kw):
    (jmodel, jparams), (tmodel, tparams) = target
    (jdraft, jdparams), (tdraft, tdparams) = draft
    kw = {**SERVER_KW, **kw}
    ref = JaxPipelineServer(jmodel, jparams,
                            spec_draft=(_jax_draft(jdraft, jmodel.cfg.vocab_size), jdparams), **kw)
    ours = PipelineServer(tmodel, tparams, device="cpu", spec_draft=(tdraft, tdparams), **kw)
    ref_reqs = _drive(ref, n_slots, events or {}, **(trace or {}))
    commits = []
    step = ours.step

    def counted_step():
        before = ours.host_readback.counts["commit"]
        step()
        commits.append(ours.host_readback.counts["commit"] - before)

    ours.step = counted_step
    our_reqs = _drive(ours, n_slots, events or {}, **(trace or {}))
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
    st = ours.stats
    assert st.spec_rounds > 0 and st.verify_calls > 0 and st.draft_calls > 0
    assert st.spec_accepted <= st.spec_proposed
    assert st.accepted_tokens == st.tokens_generated
    return ours, commits


@pytest.mark.parametrize("spec_k,kv_dtype,async_depth", [
    (4, None, 0), (4, None, 2), (1, None, 2), (4, "int8", 2), (1, "int8", 0),
])
def test_self_draft_server_matches_reference(weights, spec_k, kv_dtype, async_depth):
    ours, _ = _run_pair(weights, weights, spec_k=spec_k, kv_dtype=kv_dtype,
                        async_depth=async_depth)
    # A self-draft at fp32 replays its target's greedy chain.
    assert ours.stats.acceptance_rate > 0.9
    assert (ours.host_readback.counts["dispatch"] == 0) == (async_depth > 0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_smaller_vocabulary_draft_matches_reference(weights, kv_dtype):
    """A random stablelm draft with 100 of its target's 256 token ids:
    the target's tokens past 100 reach its embedding clamped."""
    draft = _pair("stablelm-1.6b", vocab=100, seed=1)
    ours, _ = _run_pair(weights, draft, kv_dtype=kv_dtype)
    assert ours._spec.model.cfg.vocab_size == 100
    assert ours.stats.tokens_generated > 0


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "granite-20b"])
def test_registry_pairing_matches_reference(arch):
    """The registry's drafts for qwen2.5 and granite (stablelm), smoke
    size, paged with chunked prefill beside the rounds."""
    assert default_draft_for(arch) == "stablelm-1.6b"
    target = _pair(arch)
    draft = _pair(default_draft_for(arch), seed=1)
    _run_pair(target, draft, prefill_chunk=4)


def test_spec_server_matches_reference_through_failovers(weights):
    """Replicas of both stages fail and recover mid-run: rounds in flight
    are rewound (``rewind_spec``), draft lanes rebuild from position 0."""
    events = {3: lambda s: s.fail_replica(0, 0), 6: lambda s: s.fail_replica(1, 1),
              12: lambda s: s.recover_replica(0, 0), 15: lambda s: s.recover_replica(1, 1),
              18: lambda s: s.fail_replica(0, 1), 24: lambda s: s.recover_replica(0, 1)}
    ours, _ = _run_pair(weights, weights, events=events, n_replicas=2)
    assert ours.stats.rerouted_stages > 0


def test_spec_server_matches_reference_at_one_stage_through_failover(weights):
    events = {4: lambda s: s.fail_replica(0, 0), 10: lambda s: s.recover_replica(0, 0),
              14: lambda s: s.fail_replica(0, 1), 20: lambda s: s.recover_replica(0, 1),
              22: lambda s: s.fail_replica(0, 0)}
    ours, _ = _run_pair(weights, weights, events=events, n_groups=1, n_replicas=2,
                        kv_dtype="int8")
    assert ours.stats.rerouted_stages > 0


def test_spec_server_matches_reference_under_preemption(weights):
    ours, _ = _run_pair(weights, weights, n_groups=1, n_replicas=1, page_size=8, max_pages=7,
                        n_slots=40, trace=dict(n_tokens=24, prompt_len=10))
    assert ours.stats.preempted_jobs > 0


def test_spec_readbacks_stay_at_commit_within_budget(weights):
    """The JAX engine's host-sync contract for speculation (one stage, one
    replica, chunked prefill): no readback in the dispatch phase, at most
    3 per step at commit."""
    ours, commits = _run_pair(weights, weights, n_groups=1, n_replicas=1,
                              harvest_bounds=(60.0, 80.0), prefill_chunk=4, async_depth=2)
    assert ours.host_readback.counts["dispatch"] == 0
    assert 0 < max(commits) <= 3


def test_spec_arguments_are_checked(weights):
    _, (tmodel, tparams) = weights
    with pytest.raises(ValueError, match="paged"):
        PipelineServer(tmodel, tparams, device="cpu", spec_draft=(tmodel, tparams))
    with pytest.raises(ValueError, match="spec_k"):
        PipelineServer(tmodel, tparams, device="cpu", paged=True, n_groups=2,
                       spec_draft=(tmodel, tparams), spec_k=0)
    mamba = build_model(dataclasses.replace(get_smoke_config("falcon-mamba-7b"),
                                            dtype="float32", param_dtype="float32"))
    with pytest.raises(ValueError, match="draft model"):
        PipelineServer(tmodel, tparams, device="cpu", paged=True, n_groups=2,
                       spec_draft=(mamba, None))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2.5-14b"])
def test_cli_spec_flags(capsys, arch):
    serve_cli.main(["--smoke", "--device", "cpu", "--arch", arch, "--groups", "2", "--paged",
                    "--spec-draft", "auto", "--spec-k", "4", "--slots", "20"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("policy=adaptive: submitted=")
    assert "spec_rounds=" in line and "acceptance=" in line and "accepted_tokens=" in line
