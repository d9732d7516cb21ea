r"""What does the SLO alert engine cost the serving tier's latency?

    python -m cs744_ddp_tpu_torch.utils.profile_alerts [--requests 400]
        [--rps 200] [--replicas 1] [--pairs 2] [--device cpu]
        [--buckets 1,8]

Runs the CLI ``--serve-frontend --telemetry-out S --serve-trace-client C``
once per turn, ``--serve-alerts on`` and ``off`` in turns (on, off, off,
on, ``--pairs`` times), each in a process of its own with nothing else
running beside it: VGG-11 f32 replicas on the card (``--device cpu``: on
the CPU, at small buckets), the seeded tiered trace of ``--requests``
requests at ``--rps`` over a real socket.  For each run: the client's
round trip (its ``trace_client`` spans), the server's latency (its
``serve_latency_ms`` gauges, the router's arrival to the result), each by
p50 / p99 in ms, the rules fired and the records the tap saw.  One JSON
line per run, then one JSON line of the medians by mode and on - off,
then a line for reading with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

from ..obs import percentile, read_run


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"no nvidia-smi ({type(e).__name__})"


def _p50_p99(values):
    return {"p50": round(percentile(values, 50), 3),
            "p99": round(percentile(values, 99), 3)}


def one_run(mode: str, args, tmp: str, turn: int) -> dict:
    """One CLI run with the alert engine ``mode`` ("on"/"off"): its
    latencies from the two run directories it wrote."""
    srv = os.path.join(tmp, f"{turn}_{mode}")
    client = f"{srv}_client"
    cmd = [sys.executable, "-m", "cs744_ddp_tpu_torch.cli",
           "--serve-frontend", "--serve-alerts", mode,
           "--serve-replicas", str(args.replicas),
           "--serve-requests", str(args.requests),
           "--serve-load", str(args.rps), "--telemetry-out", srv,
           "--serve-trace-client", client]
    if args.device:
        cmd += ["--device", args.device]
    if args.buckets:
        cmd += ["--serve-buckets", args.buckets]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=args.timeout,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.dirname(os.path.abspath(__file__)))))
    if proc.returncode:
        raise RuntimeError(f"alerts {mode} run failed:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    st = last["load"][f"{args.rps:g}rps"]
    if st["replies"] != args.requests or st["unresolved"]:
        raise RuntimeError(f"alerts {mode} run: load {st}")
    events = read_run(srv)[1]
    client_ms = [1e3 * e["dur_s"] for e in read_run(client)[1]
                 if e.get("kind") == "span"
                 and e.get("name") == "trace_client"]
    server_ms = [e["value"] for e in events if e.get("kind") == "gauge"
                 and e.get("name") == "serve_latency_ms"]
    return {"turn": turn, "alerts": mode,
            "fired": last.get("alerts", {}).get("fired"),
            "records": len(events), "attainment": st["attainment"],
            "client_ms": _p50_p99(client_ms),
            "server_ms": _p50_p99(server_ms)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--requests", type=int, default=400)
    p.add_argument("--rps", type=float, default=200.0)
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--pairs", type=int, default=2,
                   help="on, off, off, on this many times")
    p.add_argument("--device", help="as the CLI's --device (default the "
                   "card)")
    p.add_argument("--buckets", help="as the CLI's --serve-buckets")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds a run may take")
    args = p.parse_args(argv)
    runs = []
    with tempfile.TemporaryDirectory(prefix="alerts_ab_") as tmp:
        for turn, mode in enumerate(["on", "off", "off", "on"] * args.pairs):
            run = one_run(mode, args, tmp, turn)
            print(json.dumps(run), flush=True)
            runs.append(run)
    med = {}
    for mode in ("on", "off"):
        mine = [r for r in runs if r["alerts"] == mode]
        med[mode] = {f"{side}_{q}": round(statistics.median(
            r[side][q] for r in mine), 3)
            for side in ("client_ms", "server_ms") for q in ("p50", "p99")}
    diff = {k: round(med["on"][k] - med["off"][k], 3) for k in med["on"]}
    line = card()
    print(json.dumps({"median": med, "on_minus_off": diff, "card": line}))
    print(f"alerts on/off in turns, {args.replicas} replica(s), "
          f"{args.requests} requests at {args.rps:g} rps, {len(runs)} runs: "
          f"client p50/p99 ms on {med['on']['client_ms_p50']}/"
          f"{med['on']['client_ms_p99']}, off "
          f"{med['off']['client_ms_p50']}/{med['off']['client_ms_p99']}; "
          f"server p50/p99 ms on {med['on']['server_ms_p50']}/"
          f"{med['on']['server_ms_p99']}, off "
          f"{med['off']['server_ms_p50']}/{med['off']['server_ms_p99']}  "
          f"[{line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
