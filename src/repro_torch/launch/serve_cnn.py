"""CNN serving launcher: synthesize once, serve a stream of single images.

  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --net squeezenet \
      --scale 0.08 --input-hw 64 --requests 64 --max-batch 8 \
      --max-delay-ms 2 --rate 200 --replicas 2 --dispatch least_loaded

The port of ``repro.launch.serve_cnn``, with its flags and printout.
Synthesizes the network (Stages A–C once) with random weights from
``--seed`` on ``--device`` (``cuda`` by default; ``cpu`` runs the kernels'
plain versions), builds a :class:`~repro_torch.serving.ServingConfig` from
the flags, and drives the data-parallel
:class:`~repro_torch.serving.ReplicaSet` with an open-loop stream of
``--requests`` single images at ``--rate`` req/s (0 = back-to-back) via
:func:`repro_torch.serving.run_offered_load`.  Prints sustained throughput,
latency percentiles, per-replica warm-up (cold start) times, shed count,
and a metrics snapshot rendered from the tier's registry
(``repro_torch.obs``).  ``--metrics-out``/``--trace-out`` export the
snapshot (JSON) and the trace spans (JSONL).

``--artifact-dir PATH`` attaches a persistent
:class:`~repro_torch.artifacts.ArtifactStore` (DESIGN.md §13): the first
launch synthesizes cold and persists the program; a later launch against the
same directory hydrates it (zero synthesis iterations) and says so.  Stage D
is captured again in every process (the port serializes no CUDA graph), and
the ``artifact_*`` counters appear in the snapshot beside the cache's.
"""
from __future__ import annotations

import argparse

from repro_torch.artifacts import ArtifactStore
from repro_torch.cnn import WORKLOADS, init_network_params
from repro_torch.core import ComputeMode, synthesize
from repro_torch.obs import (MetricsRegistry, Tracer, render_table,
                             write_metrics_json, write_trace_jsonl)
from repro_torch.serving import (DISPATCH_POLICIES, ServingConfig,
                                 run_offered_load)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="squeezenet", choices=sorted(WORKLOADS))
    ap.add_argument("--scale", type=float, default=0.08)
    ap.add_argument("--input-hw", type=int, default=64)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="offered load in req/s; 0 = back-to-back")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel replica count")
    ap.add_argument("--dispatch", default="least_loaded",
                    choices=sorted(DISPATCH_POLICIES))
    ap.add_argument("--max-queue-depth", type=int, default=64,
                    help="per-replica admission bound; 0 = unbounded")
    ap.add_argument("--mode", default="relaxed",
                    choices=[m.value for m in ComputeMode])
    ap.add_argument("--artifact-dir", default=None, metavar="PATH",
                    help="persistent artifact store: synthesize cold once, "
                         "start warm after that")
    ap.add_argument("--device", default="cuda",
                    help="torch device the program runs on (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a JSON metrics snapshot here")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write trace spans as JSONL here: synthesis.*, "
                         "serve.batch_wait, serve.dispatch and its phases "
                         "(serve.lookup, .stack, .copy_in, .replay, "
                         ".copy_out, .scatter), serve.request, and on the "
                         "card dev.copy_in, dev.replay and "
                         "serve.clock_anchor; joined by the 'request' and "
                         "'bucket' attributes")
    args = ap.parse_args(argv)

    config = ServingConfig(max_batch=args.max_batch,
                           max_delay_s=args.max_delay_ms / 1e3,
                           replicas=args.replicas,
                           dispatch=args.dispatch,
                           max_queue_depth=args.max_queue_depth,
                           artifact_dir=args.artifact_dir)
    net = WORKLOADS[args.net](scale=args.scale, num_classes=args.classes,
                              input_hw=args.input_hw)
    params = init_network_params(net, args.seed, args.device)
    print(f"synthesizing {net.name} ({len(net.layers)} layers)...")
    registry = MetricsRegistry()
    tracer = Tracer(clock=registry.clock)
    store = None
    if args.artifact_dir:
        store = ArtifactStore(args.artifact_dir, registry=registry,
                              tracer=tracer)
    program = synthesize(net, params, forced_mode=ComputeMode(args.mode),
                         registry=registry, tracer=tracer,
                         artifact_store=store)
    if store is not None and store.hits:
        print(f"  program hydrated from {args.artifact_dir} "
              "(zero synthesis iterations), "
              f"program {program.fingerprint()}")
    else:
        print(f"  stages A-C in {program.synthesis_seconds:.2f}s, "
              f"program {program.fingerprint()}")

    report = run_offered_load(program, requests=args.requests,
                              rate=args.rate, config=config, seed=args.seed,
                              registry=registry, tracer=tracer)

    srv, tier = report.server_stats, report.tier_stats
    print(f"served {report.admitted}/{report.requests} requests "
          f"({report.shed_requests} shed) across {report.replica_count} "
          f"replica(s) in {report.wall_seconds:.3f}s "
          f"({report.sustained_per_s:.1f} img/s sustained)")
    print(f"latency ms: p50 {report.latency_ms(50):.2f}  "
          f"p95 {report.latency_ms(95):.2f}  max {report.latencies_ms[-1]:.2f}")
    print(f"batches: {srv['batches']}  buckets {srv['bucket_counts']}  "
          f"padding {srv['padding_fraction']:.1%}  "
          f"stolen {tier['stolen_requests']}  peak depth {tier['peak_depth']}")
    warm = ", ".join(f"r{i}={s:.2f}s" for i, s in enumerate(report.warm_seconds))
    print(f"cold start (warm-up): {warm}")
    if store is not None:
        print(f"warm start: program hydrated from {args.artifact_dir} "
              "(zero synthesis iterations); "
              f"{report.cache_stats['stage_d_compiles']} Stage-D build(s) "
              "made again (plan-only)" if store.hits else
              f"cold start: program persisted to {args.artifact_dir} "
              "(next launch starts warm)")
    print("\nmetrics snapshot:")
    print(render_table(report.registry))

    if args.metrics_out:
        write_metrics_json(args.metrics_out, report.registry,
                           meta={"net": net.name, "requests": args.requests,
                                 "replicas": args.replicas})
        print(f"\nmetrics snapshot -> {args.metrics_out}")
    if args.trace_out:
        write_trace_jsonl(args.trace_out, report.tracer or tracer)
        print(f"trace spans -> {args.trace_out}")
    return report


if __name__ == "__main__":
    main()
