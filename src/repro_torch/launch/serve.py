"""Serving CLI: the paper's decentralized inference system on PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --smoke --groups 3 --replicas 3 --policy adaptive --slots 60 \
        [--paged --prefill-chunk 32 --kv-dtype int8]
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --prefill-chunk 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b --smoke \
        --paged --spec-draft auto --spec-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --multiprocess
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --mesh-model 2 --mesh-data 2
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --multiprocess --mesh-model 2

Hosts G pipeline groups x R replicas of the (partitioned) model on one
device (CUDA unless ``--device`` says otherwise), routes requests with
the energy-aware scheduler, and prints throughput and downtime.
``--multiprocess`` runs every (group, replica) stage in its own worker
process on that device (dense whole-prompt mode). ``--mesh-model M
--mesh-data D`` serves on a ``(D, M)`` mesh: replicas go to the D data
slices round-robin, and each stage runs tensor-parallel over its slice's
M positions (with ``--multiprocess``: over M positions inside each
worker). ``--device cpu`` or an indexed card (``cuda:0``) puts every
position on that device; a bare ``cuda`` takes the visible cards and
needs ``M * D`` of them. Like the JAX CLI it serves in float32 with
random weights drawn from seed 0 (a speculative draft's from seed 1).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import ARCH_NAMES, get_config, get_smoke_config
from ..device import resolve_device
from ..launch.mesh import make_serving_mesh
from ..models import build_model, init_from_template
from ..models.registry import default_draft_for
from ..serving import MPPipelineServer, PipelineServer


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--groups", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument(
        "--policy", choices=["uniform", "long_term", "adaptive"], default="adaptive"
    )
    ap.add_argument("--slots", type=int, default=60)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="continuous-batching slots per (group, replica)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="pending-queue bound (backpressure); None = unbounded")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: per-replica page pool + block tables "
                         "instead of a dense max_batch x max_len reservation")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV entries per page (paged mode)")
    ap.add_argument("--max-pages", type=int, default=None,
                    help="pool pages per (group, replica); default matches the "
                         "dense reservation (max_batch * ceil(max_len/page_size))")
    ap.add_argument("--kv-dtype", choices=["compute", "int8"], default="compute",
                    help="paged KV page dtype: 'compute' stores pages at the "
                         "model compute dtype; 'int8' quantizes each row when "
                         "it is written (per-row fp32 scales, dequantized inside "
                         "the attention kernels)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill, dense or --paged: split joining "
                         "prompts into N-token chunks launched beside the decode "
                         "of the same step; None = whole-prompt prefill")
    ap.add_argument("--spec-draft", choices=ARCH_NAMES + ("auto",), default=None,
                    help="speculative decoding (needs --paged): the draft "
                         "architecture that proposes --spec-k tokens per round, "
                         "verified in one paged chunk call; 'auto' takes the "
                         "registry's pairing for --arch (SPEC_DRAFT_PAIRS)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative round")
    ap.add_argument("--max-park-steps", type=int, default=32,
                    help="starvation-free aging: force-place (preempting the "
                         "youngest resident of a live sibling) any failover "
                         "victim parked slotless longer than this many slots; "
                         "<= 0 disables aging")
    ap.add_argument("--async-depth", type=int, default=2,
                    help="in-flight calls per (group, replica): the producer "
                         "launches up to this many calls before the committer "
                         "reads results back from the completion queue; "
                         "1 = commit-time readback without pipelining, "
                         "0 = synchronous engine (readback at dispatch)")
    ap.add_argument("--mesh-model", type=int, default=None,
                    help="tensor-parallel width: cut each stage's weights over "
                         "a 'model' mesh axis (SERVE_RULES); every split block "
                         "runs once per position and its partials are summed")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="replica slices of the serving mesh: replicas are "
                         "assigned round-robin to mesh-data disjoint "
                         "(1, mesh-model) slices")
    ap.add_argument("--multiprocess", action="store_true",
                    help="one OS process per (group, replica) stage cell "
                         "(dense whole-prompt mode): handoffs cross process "
                         "boundaries, process death is a live membership "
                         "leave. --mesh-model then gives each worker its own "
                         "(1, mesh-model) mesh")
    ap.add_argument("--arrival-p", type=float, default=0.5)
    ap.add_argument("--harvest", type=float, nargs=2, default=(6.0, 10.0))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)

    if args.multiprocess and (args.paged or args.prefill_chunk or args.spec_draft):
        ap.error("--multiprocess is dense whole-prompt only "
                 "(no --paged / --prefill-chunk / --spec-draft)")
    device = resolve_device(args.device)
    spec_draft = None
    if args.spec_draft is not None:
        name = default_draft_for(args.arch) if args.spec_draft == "auto" else args.spec_draft
        dcfg = get_smoke_config(name) if args.smoke else get_config(name)
        dcfg = dataclasses.replace(dcfg, dtype="float32", param_dtype="float32")
        draft = build_model(dcfg)
        dgen = torch.Generator(device=device).manual_seed(1)
        spec_draft = (draft, init_from_template(draft.template, dgen, dcfg.param_dtype,
                                                device=device))
    common = dict(
        n_groups=args.groups,
        n_replicas=args.replicas,
        policy=args.policy,
        harvest_bounds=tuple(args.harvest),
        max_len=128,
        max_batch=args.max_batch,
        max_queue=args.max_queue,
        max_park_steps=args.max_park_steps if args.max_park_steps > 0 else None,
        async_depth=args.async_depth,
        seed=args.seed,
        device=device,
    )
    positions = (args.mesh_model or 1) * (1 if args.multiprocess else args.mesh_data)
    if args.mesh_model is not None or args.multiprocess:
        substrate = (f"substrate: {'multiprocess' if args.multiprocess else 'mesh'} "
                     f"model_axis={args.mesh_model or 1} data_axis={args.mesh_data} "
                     f"devices={positions}")
    if args.multiprocess:
        spec = {"arch": args.arch, "smoke": args.smoke, "seed": 0,
                "overrides": {"dtype": "float32", "param_dtype": "float32"}}
        with MPPipelineServer(spec, mesh_model=args.mesh_model or 1, **common) as server:
            print(f"substrate: multiprocess workers={args.groups * args.replicas} "
                  f"device={device}")
            if args.mesh_model is not None:
                print(substrate)
            stats = server.run(args.slots, arrival_p=args.arrival_p)
    else:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        model = build_model(cfg)
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_from_template(model.template, gen, cfg.param_dtype, device=device)
        mesh = None
        if args.mesh_model is not None:
            # A named device (cpu, cuda:0) stands at every position.
            repeat = device.type != "cuda" or device.index is not None
            mesh = make_serving_mesh(model_axis=args.mesh_model, data_axis=args.mesh_data,
                                     devices=[device] * positions if repeat else None)
            common.pop("device")
            print(substrate)
        server = PipelineServer(
            model,
            params,
            mesh=mesh,
            paged=args.paged,
            page_size=args.page_size,
            max_pages=args.max_pages,
            kv_dtype=None if args.kv_dtype == "compute" else args.kv_dtype,
            prefill_chunk=args.prefill_chunk,
            spec_draft=spec_draft,
            spec_k=args.spec_k,
            **common,
        )
        stats = server.run(args.slots, arrival_p=args.arrival_p)
    paged_info = (
        f" preempted={stats.preempted_jobs} peak_active={stats.peak_active}"
        if args.paged
        else ""
    )
    if spec_draft is not None:
        paged_info += (
            f" spec_rounds={stats.spec_rounds}"
            f" acceptance={stats.acceptance_rate:.3f}"
            f" accepted_tokens={stats.accepted_tokens}"
        )
    print(
        f"policy={args.policy}: submitted={stats.submitted} "
        f"completed={stats.completed_jobs} dropped={stats.dropped_jobs} "
        f"queued={stats.queued_jobs} tokens={stats.tokens_generated} "
        f"decode_calls={stats.decode_calls} "
        f"downtime={stats.downtime_fraction:.3f} "
        f"rerouted={stats.rerouted_stages}" + paged_info
    )


if __name__ == "__main__":
    main()
