"""Run one benchmark cell once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks. Without a CUDA card,
or with fewer cards than the cell needs, it prints no result and exits 2;
it exits 3 when the run loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path[0] == str(ROOT / "port_bench"):  # run as a script: the checkout's root instead
    sys.path[0] = str(ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--overrides", default="{}", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from port_bench import harness

    try:
        line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                device=args.device, t0=T0, overrides=json.loads(args.overrides))
    except harness.SetupError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 3 if "loaded" in str(e) else 2
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
