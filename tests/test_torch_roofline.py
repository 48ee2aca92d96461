"""The port's roofline and cost tally on the CPU (``repro_torch.roofline``):
the H100 constants; ``RooflineTerms``, ``static_*`` and
``top_contributors`` against the JAX package's with JAX's ``hw`` constants
set to the port's; what :class:`CostTally` counts for a known op; every
kernel wrapper's ``meta`` route against its plain version (the outputs'
shapes and dtypes, and the reported FLOPs against the plain version's
counted matmul FLOPs, or a closed form for the scan and rmsnorm); and the
serving package's exports against JAX's.

FLOPs and bytes are counts of shapes, so every comparison is exact.
"""

import ast
import re
import types
from pathlib import Path

import pytest
import torch

import repro.roofline.analysis as jax_analysis
import repro.roofline.hw as jax_hw
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_ref_model, paged_decode_attention,
    paged_decode_attention_ref, paged_prefill_attention, paged_prefill_attention_ref)
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
    flash_attention_ref)
from repro_torch.kernels.flash_attention.ref import attention_lse_ref
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.selective_scan import (
    selective_scan, selective_scan_bwd, selective_scan_bwd_ref, selective_scan_fwd,
    selective_scan_ref)
from repro_torch.kernels.selective_scan.ops import CKPT_STEPS
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import reduce_partials
from repro_torch.roofline import (
    CostTally, RooflineTerms, hw, roofline_terms, static_memory_seconds,
    static_roofline_terms, top_contributors)

REPO = Path(__file__).resolve().parents[1]
MATMULS = ("aten.mm.", "aten.bmm.", "aten.addmm.", "aten.baddbmm.")


def _matmul_flops(tally) -> float:
    return sum(row[1] for (op, _), row in tally.ops.items() if op.startswith(MATMULS))


def _meta(t):
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def _sig(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [None if t is None else (tuple(t.shape), t.dtype) for t in outs]


# ---------------------------------------------------------------------------
# The card's constants and the roofline arithmetic against JAX's
# ---------------------------------------------------------------------------

def test_h100_constants():
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_TF32, hw.PEAK_FLOPS_FP32) == (989e12, 494.7e12,
                                                                            67e12)
    assert (hw.HBM_BW, hw.ICI_BW_PER_LINK) == (3.35e12, 450e9)
    # The card's own total_memory (torch.cuda.get_device_properties), 79.2 GiB.
    assert hw.HBM_BYTES == 85_017_493_504
    assert "H100" in hw.__doc__ and "notional" in hw.__doc__


@pytest.fixture
def jax_on_h100(monkeypatch):
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW_PER_LINK", "HBM_BYTES"):
        monkeypatch.setattr(jax_hw, name, getattr(hw, name))


@pytest.mark.parametrize("flops,hbm,coll,chips", [
    (1.3e16, 4.8e12, 2.6e10, 256),   # compute-dominated
    (2.0e12, 9.9e12, 1.0e9, 4),      # memory-dominated
    (1.0e9, 1.0e9, 5.0e11, 512),     # collective-dominated
    (0.0, 0.0, 0.0, 1),              # nothing: compute wins the tie, as in JAX
])
def test_roofline_terms_match_jax(jax_on_h100, flops, hbm, coll, chips):
    mine = RooflineTerms(flops=flops, hbm_bytes=hbm, collective_bytes=coll, chips=chips)
    ref = jax_analysis.RooflineTerms(flops=flops, hbm_bytes=hbm, collective_bytes=coll,
                                     chips=chips)
    assert mine.as_dict() == ref.as_dict()
    assert static_memory_seconds(hbm, chips) == jax_analysis.static_memory_seconds(hbm, chips)
    assert static_roofline_terms(hbm, chips).as_dict() == \
        jax_analysis.static_roofline_terms(hbm, chips).as_dict()


@pytest.mark.parametrize("dtype,peak", [("float32", 67e12), (torch.float32, 67e12),
                                        ("bfloat16", 989e12), (torch.float16, 989e12)])
def test_compute_term_takes_the_peak_of_the_steps_dtype(dtype, peak):
    """An fp32 step runs its matmuls on the CUDA cores (TF32 is off), a
    bf16 / fp16 step on the tensor cores: the compute term divides by that
    peak; the other terms do not move."""
    assert hw.peak_flops(dtype) == peak
    flops, hbm, coll, chips = 1.3e16, 4.8e12, 2.6e10, 256
    bf16 = RooflineTerms(flops=flops, hbm_bytes=hbm, collective_bytes=coll, chips=chips)
    mine = RooflineTerms(flops=flops, hbm_bytes=hbm, collective_bytes=coll, chips=chips,
                         peak_flops=hw.peak_flops(dtype))
    assert mine.compute_s == flops / (chips * peak)
    assert (mine.memory_s, mine.collective_s) == (bf16.memory_s, bf16.collective_s)
    if peak == 67e12:  # 0.758 s of fp32 compute against 0.0056 s of memory
        assert mine.dominant == "compute" and mine.compute_s > 14 * bf16.compute_s


def test_peak_of_an_unknown_dtype_raises():
    with pytest.raises(ValueError, match="no peak"):
        hw.peak_flops(torch.int8)


def test_tally_sees_the_collectives_only_while_active():
    """A tally installs itself as the collectives' observer for its span
    only: outside one the collectives keep no count."""
    a, b = torch.ones(4, 8), torch.ones(4, 8)
    reduce_partials([a, b])
    assert collectives.OBSERVERS == []
    with CostTally(positions=2) as t:
        reduce_partials([a, b])
    reduce_partials([a, b])
    assert collectives.OBSERVERS == []
    assert t.collectives["all-reduce"] == {"count": 1, "bytes": 4 * 32}
    assert t.collective_bytes == 4 * 32
    assert sum(v["count"] for v in t.collectives.values()) == 1


def _tally_of_a_small_step():
    a = torch.randn(64, 32)
    b = torch.randn(32, 16)
    with CostTally() as t:
        c = a @ b
        d = torch.exp(c)
        e = d + 1.0
        e.sum()
    return t


def test_top_contributors_sorts_limits_and_rejects_as_jax():
    t = _tally_of_a_small_step()
    for mode in ("bytes", "flops"):
        rows = top_contributors(t, mode)
        assert rows and all(isinstance(v, float) and v > 0 for v, _, _ in rows)
        assert [v for v, _, _ in rows] == sorted((v for v, _, _ in rows), reverse=True)
        assert top_contributors(t, mode, limit=2) == rows[:2]
    assert top_contributors(t, "flops")[0][1] == "aten.mm.default"
    assert top_contributors(t, "coll") == []
    with pytest.raises(ValueError) as mine:
        top_contributors(t, "time")
    with pytest.raises(ValueError) as ref:
        jax_analysis.top_contributors("", "time")
    assert str(mine.value) == str(ref.value)


def test_tally_counts_a_matmul_elementwise_ops_and_views():
    t = _tally_of_a_small_step()
    ops = {op: row for (op, _), row in t.ops.items()}
    assert ops["aten.mm.default"][1] == 2 * 64 * 32 * 16
    assert ops["aten.mm.default"][2] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert ops["aten.exp.default"][1] == 64 * 16  # one FLOP an element
    assert ops["aten.sum.default"][1] == 0  # reductions count none, as JAX's walker
    x = torch.randn(8, 8)
    with CostTally() as t:
        x.t()[:4].unsqueeze(0).expand(3, 4, 8)
    assert t.bytes == 0  # views move nothing
    terms, cost = roofline_terms(_tally_of_a_small_step(), 4)
    assert terms.flops == 4 * cost.flops and terms.chips == 4


def test_tally_follows_live_bytes_and_arguments():
    x = torch.empty(1000, device="meta")
    with CostTally() as t:
        t.arguments([x])
        for _ in range(3):
            y = x * 2
            z = y + 1
            del y, z
    assert t.args == [4000] and t.live == [4000]
    assert t.peak == [12000] and t.temp() == [8000]


# ---------------------------------------------------------------------------
# The kernel wrappers' meta routes against their plain versions
# ---------------------------------------------------------------------------

def _meta_run(fn, *args, **kwargs):
    with CostTally() as t:
        out = fn(*[_meta(a) if isinstance(a, torch.Tensor) else a for a in args],
                 **{k: _meta(v) if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()})
    return out, t


def _plain_run(fn, *args, **kwargs):
    with CostTally() as t:
        out = fn(*args, **kwargs)
    return out, t


FLASH = [  # B, Sq, Skv, H, KV, D, causal, window
    (2, 24, 24, 4, 2, 16, False, None),
    (2, 24, 24, 4, 4, 8, True, None),
    (1, 40, 40, 4, 2, 16, True, 12),
    (2, 8, 20, 4, 2, 16, False, None),  # cross: Sq != Skv
]


def _flash_inputs(B, Sq, Skv, H, KV, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, Sq, H, D, generator=g), torch.randn(B, Skv, KV, D, generator=g),
            torch.randn(B, Skv, KV, D, generator=g))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window", FLASH)
def test_flash_meta_route(B, Sq, Skv, H, KV, D, causal, window):
    q, k, v = _flash_inputs(B, Sq, Skv, H, KV, D)
    kw = dict(causal=causal, window=window)
    out, t = _meta_run(flash_attention, q, k, v, **kw)
    want, plain = _plain_run(flash_attention_ref, q, k, v, **kw)
    assert out.device.type == "meta" and _sig(out) == _sig(want)
    # The plain version scores every (query, key) pair; the kernel the
    # pairs its mask lets through.
    pairs = sum(min(i + 1, Skv, window or Skv) for i in range(Sq)) if causal else Sq * Skv
    assert t.kernels["flash_attention"]["count"] == 1
    assert t.kernels["flash_attention"]["flops"] == _matmul_flops(plain) * pairs / (Sq * Skv)
    assert flash_attention.launches == 0
    (o, lse), _ = _meta_run(flash_attention_fwd, q, k, v, **kw)
    assert _sig((o, lse)) == _sig((want, attention_lse_ref(q, k, **kw)))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window", FLASH)
def test_flash_meta_route_under_grad(B, Sq, Skv, H, KV, D, causal, window):
    q, k, v = _flash_inputs(B, Sq, Skv, H, KV, D)
    kw = dict(causal=causal, window=window)
    qm, km, vm = (_meta(x).requires_grad_() for x in (q, k, v))
    with CostTally() as t:
        out = flash_attention(qm, km, vm, **kw)
        grads = torch.autograd.grad(out.sum(), (qm, km, vm))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert t.kernels["flash_attention"]["count"] == t.kernels["flash_attention_bwd"]["count"] == 1
    o = flash_attention_ref(q, k, v, **kw)
    lse = attention_lse_ref(q, k, **kw)
    do = torch.randn_like(o)
    want, plain = _plain_run(flash_attention_bwd_ref, q, k, v, o, lse, do, **kw)
    got, tb = _meta_run(flash_attention_bwd, q, k, v, o, lse, do, **kw)
    assert _sig(got) == _sig(want)
    pairs = sum(min(i + 1, Skv, window or Skv) for i in range(Sq)) if causal else Sq * Skv
    assert tb.kernels["flash_attention_bwd"]["flops"] == \
        _matmul_flops(plain) * pairs / (Sq * Skv) == 10 * B * H * D * pairs
    assert flash_attention_bwd.launches == 0


@pytest.mark.parametrize("window", [None, 20])
def test_decode_meta_route(window):
    g = torch.Generator().manual_seed(1)
    B, S, H, KV, D = 3, 32, 4, 2, 16
    q = torch.randn(B, 1, H, D, generator=g)
    kc, vc = torch.randn(B, S, KV, D, generator=g), torch.randn(B, S, KV, D, generator=g)
    lens = torch.tensor([5, 32, 17], dtype=torch.int32)
    out, t = _meta_run(decode_attention, q, kc, vc, lens, window=window)
    want, plain = _plain_run(decode_attention_ref_model, q, kc, vc, lens, window=window)
    assert _sig(out) == _sig(want)
    # Lengths stay on the device: every row a lane can see counts.
    rows = min(S, window or S)
    assert t.kernels["decode_attention"]["flops"] == _matmul_flops(plain) * rows / S \
        == 4 * H * D * B * rows
    assert decode_attention.launches == 0


def _pools(int8: bool, P=7, page=16, KV=2, D=64, seed=2):
    g = torch.Generator().manual_seed(seed)
    if int8:
        k = torch.randint(-127, 128, (P, page, KV, D), generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, (P, page, KV, D), generator=g, dtype=torch.int8)
        ks, vs = torch.rand(P, page, generator=g), torch.rand(P, page, generator=g)
        return k, v, ks, vs
    return (torch.randn(P, page, KV, D, generator=g), torch.randn(P, page, KV, D, generator=g),
            None, None)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_meta_routes(int8):
    k, v, ks, vs = _pools(int8)
    bt = torch.tensor([[3, 1, 5], [0, 6, 2]], dtype=torch.int32)
    g = torch.Generator().manual_seed(3)
    B, H, D = 2, 4, 64
    q = torch.randn(B, 1, H, D, generator=g)
    lens = torch.tensor([20, 48], dtype=torch.int32)
    out, t = _meta_run(paged_decode_attention, q, k, v, bt, lens, k_scales=ks, v_scales=vs)
    want, plain = _plain_run(paged_decode_attention_ref, q, k, v, bt, lens, k_scales=ks,
                             v_scales=vs)
    assert _sig(out) == _sig(want)
    assert t.kernels["paged_decode_attention"]["flops"] == _matmul_flops(plain)
    qc = torch.randn(B, 4, H, D, generator=g)
    offs = torch.tensor([0, 30], dtype=torch.int32)
    out, t = _meta_run(paged_prefill_attention, qc, k, v, bt, offs, k_scales=ks, v_scales=vs)
    want, plain = _plain_run(paged_prefill_attention_ref, qc, k, v, bt, offs, k_scales=ks,
                             v_scales=vs)
    assert _sig(out) == _sig(want)
    assert t.kernels["paged_prefill_attention"]["flops"] == _matmul_flops(plain)
    assert paged_decode_attention.launches == paged_prefill_attention.launches == 0


def _scan_inputs(B, S, Din, N, with_h0, seed=4):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return (r(B, S, Din), torch.nn.functional.softplus(r(B, S, Din)), r(B, S, N), r(B, S, N),
            -torch.exp(r(Din, N)), r(B, Din, N) if with_h0 else None)


@pytest.mark.parametrize("B,S,Din,N,with_h0", [(2, 13, 6, 4, False), (1, 16, 8, 16, True)])
def test_scan_meta_routes(B, S, Din, N, with_h0):
    ops = _scan_inputs(B, S, Din, N, with_h0)
    (y, h), t = _meta_run(selective_scan, *ops)
    assert _sig((y, h)) == _sig(selective_scan_ref(*ops))
    # Closed form: per (b, t, d, n) the exp's argument, the update, the
    # input and output products and the sum; dt * x per (b, t, d).
    assert t.kernels["selective_scan"]["flops"] == B * S * Din * (6 * N + 1)
    (y, h, ckpt), _ = _meta_run(selective_scan_fwd, *ops)
    assert tuple(ckpt.shape) == (B, -(-S // CKPT_STEPS), Din, N) and ckpt.dtype == torch.float32
    x, dt, Bm, Cm, A, h0 = ops
    dy, dh = torch.randn(B, S, Din), torch.randn(B, Din, N)
    got, tb = _meta_run(selective_scan_bwd, x, dt, Bm, Cm, A, h0, ckpt, dy, dh)
    assert _sig(got) == _sig(selective_scan_bwd_ref(x, dt, Bm, Cm, A, h0, dy, dh))
    assert tb.kernels["selective_scan_bwd"]["flops"] == 24 * B * S * Din * N
    assert selective_scan.launches == selective_scan_bwd.launches == 0


def test_scan_meta_checkpoints_under_grad_match_the_kernel_source():
    chunk = int(re.search(r"constexpr int kChunk = (\d+);",
                          (REPO / "src/repro_torch/kernels/csrc/selective_scan.cuh").read_text())
                .group(1))
    assert CKPT_STEPS == chunk
    ops = [None if a is None else _meta(a).requires_grad_()
           for a in _scan_inputs(2, 19, 6, 4, True)]
    with CostTally() as t:
        y, h = selective_scan(*ops)
        grads = torch.autograd.grad((y.sum(), h.sum()), [a for a in ops])
    assert [g.shape for g in grads] == [a.shape for a in ops]
    # Under grad the forward also writes the checkpoints: their bytes count.
    n_state = 2 * 6 * 4
    assert t.kernels["selective_scan"]["bytes"] == 4 * (
        3 * 2 * 19 * 6 + 2 * 2 * 19 * 4 + 6 * 4 + 2 * n_state + 3 * n_state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_meta_route(dtype):
    x, w = torch.randn(5, 3, 64).to(dtype), torch.randn(64).to(dtype)
    out, t = _meta_run(rmsnorm, x, w)
    assert _sig(out) == _sig(rmsnorm_ref(x, w))
    item = x.element_size()
    assert (t.kernels["rmsnorm"]["flops"], t.kernels["rmsnorm"]["bytes"]) == (
        4 * 15 * 64, 2 * 15 * 64 * item + 64 * item)


@pytest.mark.parametrize("call", [
    lambda q: flash_attention(q, q, q),
    lambda q: decode_attention(q, q, q, q),
    lambda q: paged_decode_attention(q, q, q, q, q),
    lambda q: paged_prefill_attention(q, q, q, q, q),
    lambda q: selective_scan(q, q, q, q, q),
    lambda q: rmsnorm(q, q),
])
def test_wrappers_raise_on_other_devices(call):
    fake = types.SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(ValueError, match="unsupported device"):
        call(fake)


# ---------------------------------------------------------------------------
# Serving's exports against JAX's
# ---------------------------------------------------------------------------

def _all_names(path: Path) -> set[str]:
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"no __all__ in {path}")


def test_serving_exports_match_jax():
    import repro_torch.serving as port

    jax_names = _all_names(REPO / "src/repro/serving/__init__.py")
    # Not ported on purpose (ROADMAP): JAX's jit cache-miss counters; the
    # port's own addition: HostReadback, its readback counter.
    assert set(port.__all__) - {"HostReadback"} == jax_names - {"trace_counts",
                                                                "reset_trace_counts"}
    assert all(hasattr(port, name) for name in port.__all__)
