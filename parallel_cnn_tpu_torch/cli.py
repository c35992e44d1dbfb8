"""Command line of the port: the ``serve`` and ``loadgen`` subcommands
(the counterpart of the serve branch of ``parallel_cnn_tpu/cli.py``).

    python -m parallel_cnn_tpu_torch serve --model resnet18
    python -m parallel_cnn_tpu_torch loadgen --requests 512 --pattern open

Both run on the GPU unless ``--device cpu`` is given. Admission control,
the autoscaler, scenarios, chaos, the network front door, the disk cache
and observability flags come with later slices of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional

from parallel_cnn_tpu_torch.config import SERVE_MODELS, ServeConfig


def build_serve_parser(cmd: str) -> argparse.ArgumentParser:
    """Flags of `serve` and `loadgen`; defaults come from
    ServeConfig.from_env() (the PCNN_SERVE_* names of the JAX package)."""
    sc = ServeConfig.from_env()
    p = argparse.ArgumentParser(
        prog=f"parallel_cnn_tpu_torch {cmd}",
        description=(
            "inference serving on the GPU: checkpoint → shape-bucketed, "
            "dynamically batched predict"
            if cmd == "serve"
            else "drive the serving stack with seeded traffic and report "
                 "latency percentiles / shed rate"
        ),
    )
    p.add_argument("--model", default=sc.model, choices=list(SERVE_MODELS),
                   help="registry name [PCNN_SERVE_MODEL]")
    p.add_argument("--checkpoint", default=sc.checkpoint,
                   help="restore params + BN stats from a zoo checkpoint "
                        "the JAX trainer wrote (.npz; optimizer state "
                        "ignored) [PCNN_SERVE_CHECKPOINT]")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; every visible card) or cpu, which "
                        "runs the kernels' plain PyTorch versions")
    p.add_argument("--max-batch", type=int, default=sc.max_batch,
                   help="top shape bucket (power of two) "
                        "[PCNN_SERVE_MAX_BATCH]")
    p.add_argument("--max-wait-ms", type=float, default=sc.max_wait_ms,
                   help="batch coalescing window [PCNN_SERVE_MAX_WAIT_MS]")
    p.add_argument("--queue-depth", type=int, default=sc.queue_depth,
                   help="bounded request queue; full → typed Overloaded "
                        "shed [PCNN_SERVE_QUEUE_DEPTH]")
    p.add_argument("--replicas", type=int, default=sc.n_replicas,
                   help="engine replicas pinned round-robin across local "
                        "devices [PCNN_SERVE_REPLICAS]")
    p.add_argument("--deadline-ms", type=float, default=sc.deadline_ms,
                   help="per-request deadline budget (0 = none) "
                        "[PCNN_SERVE_DEADLINE_MS]")
    p.add_argument("--no-precompile", action="store_true",
                   help="warm buckets lazily on first use instead of at "
                        "startup [PCNN_SERVE_PRECOMPILE=0]")
    p.add_argument("--requests", type=int,
                   default=64 if cmd == "serve" else 512,
                   help="traffic volume to drive through the stack")
    p.add_argument("--pattern", default="closed", choices=["closed", "open"],
                   help="arrival pattern (serve/loadgen.py): closed-loop "
                        "concurrency or open-loop Poisson")
    p.add_argument("--concurrency", type=int, default=8,
                   help="closed loop: synchronous client count")
    p.add_argument("--rate", type=float, default=500.0,
                   help="open loop: offered Poisson rate, req/s")
    p.add_argument("--seed", type=int, default=0,
                   help="weights (without --checkpoint), payload and "
                        "arrival-process seed")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the report/telemetry snapshot as JSON")
    return p


def _serve_config_from_args(args: argparse.Namespace) -> ServeConfig:
    return ServeConfig(
        model=args.model,
        checkpoint=args.checkpoint,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth,
        n_replicas=args.replicas,
        deadline_ms=args.deadline_ms,
        precompile=not args.no_precompile,
    )


def padded_bucket_parity(engine, in_shape, seed: int = 0) -> str:
    """Predict n = b−1 samples through the padded bucket b and compare
    with the raw forward on the same bucket: "bit-identical" or a
    MISMATCH line with the largest difference."""
    import numpy as np
    import torch

    from parallel_cnn_tpu_torch.serve import loadgen

    b = min(4, engine.max_batch)
    n = max(b - 1, 1)
    xs = loadgen.make_samples(n, in_shape, seed=seed)
    got = engine.predict(xs)
    full = np.concatenate([xs, np.zeros((b - n, *in_shape), np.float32)])
    ref = engine.forward(torch.from_numpy(full).to(engine.device))
    ref = ref.cpu().numpy()[:n]
    parity = "bit-identical" if np.array_equal(got, ref) else (
        f"MISMATCH (max |Δ| {float(np.max(np.abs(got - ref))):.2e})"
    )
    return f"padded-bucket parity (n={n}→b{b}): {parity}"


def _run_serve(cmd: str, argv: List[str]) -> int:
    """`serve` restores (or initialises) the model, warms the bucket
    ladder, proves the padding parity contract on one padded bucket,
    drives a short run of traffic and prints the telemetry. `loadgen` is
    the same stack under a chosen arrival pattern."""
    args = build_serve_parser(cmd).parse_args(argv)
    cfg = _serve_config_from_args(args)

    from parallel_cnn_tpu_torch.ops import tap_conv
    from parallel_cnn_tpu_torch.serve import get, loadgen, serve_stack

    handle = get(cfg.model)
    t0 = time.perf_counter()
    pool, batcher = serve_stack(handle, cfg, device=args.device, seed=args.seed)
    startup = time.perf_counter() - t0
    src = cfg.checkpoint or "fresh init (no --checkpoint)"
    print(f"[serve] model={cfg.model} params from {src}")
    print(f"[serve] replicas={cfg.n_replicas} on "
          f"{[str(e.device) for e in pool.engines]}")
    if cfg.precompile:
        buckets = pool.engines[0].stats.warm_seconds
        table = ", ".join(f"b{b}: {s * 1e3:.0f} ms"
                          for b, s in sorted(buckets.items()))
        print(f"[serve] bucket ladder warmed in {startup:.2f}s ({table})")

    rc = 0
    with batcher:
        if cmd == "serve":
            line = padded_bucket_parity(pool.engines[0], handle.in_shape,
                                        seed=args.seed)
            print(f"[serve] {line}")
            if "MISMATCH" in line:
                rc = 1
        report = loadgen.run(
            batcher,
            pattern=args.pattern,
            n_requests=args.requests,
            concurrency=args.concurrency,
            rate=args.rate,
            deadline_ms=args.deadline_ms or None,
            seed=args.seed,
        )
        print(f"[{cmd}] {args.pattern}-loop: "
              f"{report.completed}/{report.requests} ok, "
              f"{report.throughput:.1f} req/s, "
              f"shed rate {report.shed_rate:.3f}")
        lat = report.latency.summary(scale=1e3)
        if lat.get("count"):
            print(f"[{cmd}] latency p50 {lat['p50']:.2f} ms, "
                  f"p90 {lat['p90']:.2f} ms, p99 {lat['p99']:.2f} ms")
        if pool.engines[0].device.type == "cuda":
            print(f"[{cmd}] tap_conv kernel launches: {tap_conv.launches.count}")
        print(batcher.stats.render())
        if args.json:
            out = {"config": dataclasses.asdict(cfg),
                   "report": report.to_dict(),
                   "telemetry": batcher.stats.snapshot(),
                   "window": batcher.stats.window_snapshot()}
            with open(args.json, "w") as f:
                json.dump(out, f, indent=2)
            print(f"[{cmd}] report written to {args.json}")
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    raw = list(sys.argv[1:] if argv is None else argv)
    if raw and raw[0] in ("serve", "loadgen"):
        return _run_serve(raw[0], raw[1:])
    print("usage: python -m parallel_cnn_tpu_torch {serve,loadgen} [flags]\n"
          "  (training, check and bench subcommands come with later "
          "slices of the port)", file=sys.stderr)
    return 2
