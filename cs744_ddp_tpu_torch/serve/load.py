"""Serving load-trace generator + open-loop replay client -- the port's
counterpart of the reference's ``tools/serve_load.py``: the same
subcommands, flags and JSON, over the port's ``demo`` and
``FrontendClient`` (it imports no JAX, so it runs where only the port is
installed).  The wire protocol is the reference's byte for byte, so it
replays against either package's ``--serve-frontend`` server.

* ``gen``    — write a seeded tiered load trace (``demo.
  synthetic_load_trace``) as JSON: ``{"trace": [[t_s, n_images, tier,
  slo_ms], ...], "meta": {...}}``.  Deterministic in (seed, rps,
  requests), so a committed trace file IS the workload.
* ``replay`` — replay a trace file open-loop over the wire protocol
  against a running ``--serve-frontend`` server (or ``gen`` + replay in
  one shot with ``--rps``), printing the goodput/SLO-attainment stats
  sheet as one JSON line.  Requests are submitted at their scheduled
  arrival times regardless of completion — offered load is the
  independent variable.

    python -m cs744_ddp_tpu_torch.serve.load gen --requests 2000 \\
        --rps 1000 --seed 0 -o trace.json
    python -m cs744_ddp_tpu_torch.serve.load replay trace.json --port 7447
"""

from __future__ import annotations

import argparse
import json
import sys

from . import demo
from .frontend import FrontendClient


def _parse_tiers(spec):
    """``tier:weight:slo_ms`` triples -> the tiers mixture tuple."""
    if not spec:
        return demo.DEFAULT_TIERS
    tiers = []
    for s in spec:
        tier, weight, slo = s.split(":")
        tiers.append((int(tier), float(weight), float(slo)))
    return tuple(tiers)


def gen_trace(args) -> dict:
    sizes = demo.SIZE_CHOICES
    if args.max_size is not None:
        sizes = tuple(s for s in sizes if s <= args.max_size)
    trace = demo.synthetic_load_trace(
        args.requests, offered_rps=args.rps, seed=args.seed,
        size_choices=sizes, tiers=_parse_tiers(args.tier))
    return {
        "trace": [[round(t, 9), n, tier, slo] for t, n, tier, slo in trace],
        "meta": {"requests": args.requests, "offered_rps": args.rps,
                 "seed": args.seed,
                 "tiers": [list(t) for t in _parse_tiers(args.tier)]},
    }


def cmd_gen(args) -> int:
    doc = gen_trace(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f)
        print(f"wrote {len(doc['trace'])} requests to {args.out}")
    else:
        print(json.dumps(doc))
    return 0


def cmd_replay(args) -> int:
    if args.trace:
        with open(args.trace) as f:
            doc = json.load(f)
        trace = [tuple(row) for row in doc["trace"]]
        seed = int(doc.get("meta", {}).get("seed", args.seed))
    else:
        if args.rps is None:
            raise SystemExit("replay needs a trace file or --rps")
        doc = gen_trace(args)
        trace = [tuple(row) for row in doc["trace"]]
        seed = args.seed
    pool = demo.request_pool(seed=123)
    # --telemetry-out makes this CLIENT process one stream of a
    # distributed trace: each request gets a root TraceContext riding
    # the wire extension, and the client-side ``trace_client`` spans
    # land in our own events.jsonl for tools/trace_waterfall.py to
    # skew-correct against the server's stream.
    telemetry = None
    if args.telemetry_out:
        from ..obs import Telemetry
        telemetry = Telemetry(args.telemetry_out)
    try:
        with FrontendClient((args.host, args.port), timeout=args.timeout,
                            telemetry=telemetry) as client:
            stats = demo.replay_load(client, trace, pool=pool, seed=seed,
                                     drain_timeout_s=args.timeout)
    finally:
        if telemetry is not None:
            telemetry.finalize()
    print(json.dumps(stats))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cs744_ddp_tpu_torch.serve.load",
        description="seeded serving load-trace generator + open-loop "
                    "replay client (wire protocol)")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen", help="generate a seeded tiered load trace")
    g.add_argument("--requests", type=int, default=1000)
    g.add_argument("--rps", type=float, default=500.0,
                   help="offered load, requests/sec")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--tier", action="append", default=None,
                   metavar="TIER:WEIGHT:SLO_MS",
                   help="tier mixture entry (repeatable; default "
                        "0:2:75 1:5:200 2:3:600)")
    g.add_argument("--max-size", type=int, default=None, metavar="N",
                   help="cap request sizes at N images (match the "
                        "server's largest bucket)")
    g.add_argument("-o", "--out", default=None,
                   help="trace file (default: print one JSON line)")
    g.set_defaults(fn=cmd_gen)

    r = sub.add_parser("replay", help="replay a trace against a running "
                                      "--serve-frontend server")
    r.add_argument("trace", nargs="?", default=None,
                   help="trace file from gen (omit to generate inline "
                        "with --rps/--requests)")
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("--port", type=int, required=True)
    r.add_argument("--requests", type=int, default=1000)
    r.add_argument("--rps", type=float, default=None)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--tier", action="append", default=None,
                   metavar="TIER:WEIGHT:SLO_MS")
    r.add_argument("--max-size", type=int, default=None, metavar="N")
    r.add_argument("--timeout", type=float, default=120.0,
                   help="drain timeout seconds")
    r.add_argument("--telemetry-out", default=None, metavar="DIR",
                   help="write client-side trace spans (events.jsonl) "
                        "here; enables distributed tracing on every "
                        "request via the wire extension")
    r.set_defaults(fn=cmd_replay)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
