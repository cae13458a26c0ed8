"""The readings each cell's output limits are set from, on the card at the
cell's own sizes, in one process:

    python3 port_bench/calibrate.py --workload <cell> --seeds 101-112 --control 101-103

For every seed the program's timed entry (the cell's own build: the
Predictor's banded route, or the Trainer's first steps through the loader's
feed) against the reference: the *lower* readings. On the ``--control``
seeds the control, the reference with float8 operands
(``reference.lowp``), in the program's place, and in training cells the
fault a run can have that needs a run, planted in the reference put in the
program's place: half of each batch left out (the mean over the rest): the
*upper* readings. A state left unchanged reads 1 by the gaps' definition
and needs no run. One JSON line a reading goes to ``--out`` and a summary
to standard output.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path[0] == str(ROOT / "port_bench"):  # run as a script: the checkout's root instead
    sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import harness, program  # noqa: E402
from port_bench.reference import fp32  # noqa: E402
from port_bench.reference.lowp import float8_operands  # noqa: E402


def seeds_of(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def frames(cell, seed, control: bool, device):
    from port_bench.traffic import serve_frames as sf

    mix = cell.traffic
    pred, mosaics, ratios = sf.build(cell, seed, device, harness.Clock(time.perf_counter()))
    n = mix["sample"]
    outs = [pred.raw_u16(mosaics[k], float(ratios[k])) for k in range(n)]
    del pred
    free(device)
    rows = []
    with fp32():
        ref = program.reference_model(cell.config, seed, device).eval()
        for k in range(n):
            args = (ref, mosaics[k], float(ratios[k]), mix["pad_to"], device)
            want = sf.reference_answer(*args)
            plain = sf.reference_answer(*args, sf.plain_dtype(cell.config))
            rows.append({"side": "program", "frame": k, **sf.frame_gaps(outs[k], want, plain)})
            if control:
                with float8_operands():
                    low = sf.reference_answer(*args)
                rows.append({"side": "control", "frame": k,
                             **sf.frame_gaps(low.cpu().numpy(), want, plain)})
    return rows


def steps(cell, seed, control: bool, device):
    from bayer_low_light_image_enhancement_tpu_torch.data.pipeline import prefetch_to_device
    from bayer_low_light_image_enhancement_tpu_torch.train.trainer import TrainConfig, Trainer
    from port_bench.traffic import train_steps as ts

    mix = cell.traffic
    batches = ts.batch_pool(mix, seed, device)[:mix["first_steps"]]
    trainer = Trainer(program.port_model(cell.config, seed, device), TrainConfig())
    prog = ts.first_steps(trainer, prefetch_to_device(iter(batches), device), mix["first_steps"])
    del trainer
    free(device)
    ref = ts.reference_steps(cell.config, seed, device, batches, mix["ref_block_rows"])
    rows = [{"side": "program", **ts.train_gaps(prog, ref)}]
    if control:
        with float8_operands():
            low = ts.reference_steps(cell.config, seed, device, batches, mix["ref_block_rows"])
        rows.append({"side": "control", **ts.train_gaps(low, ref)})
        half = [tuple(a[:len(a) // 2] for a in b) for b in batches]
        rows.append({"side": "fault: half the batch", **ts.train_gaps(
            ts.reference_steps(cell.config, seed, device, half, mix["ref_block_rows"]), ref)})
    free(device)
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--overrides", default="{}")
    args = p.parse_args()
    cell = harness.Cell.find(args.workload)
    for part, over in json.loads(args.overrides).items():
        getattr(cell, part).update(over)
    harness.check_device(1, args.device)
    control = set(seeds_of(args.control)) if args.control else set()
    read = frames if cell.traffic["kind"] == "serve_frames" else steps
    sink = open(args.out, "a") if args.out else None
    table = {}
    try:
        for seed in seeds_of(args.seeds):
            t = time.perf_counter()
            for row in read(cell, seed, seed in control, args.device):
                row = {"workload": cell.name, "seed": seed, **row}
                if "leaves" in row:
                    row["leaves"] = list(row["leaves"])
                if sink:
                    sink.write(json.dumps(row) + "\n")
                    sink.flush()
                for k, v in row.items():
                    if isinstance(v, float):
                        table.setdefault(row["side"], {}).setdefault(k, []).append(v)
            print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    finally:
        if sink:
            sink.close()
    for side, numbers in table.items():
        for k, vs in numbers.items():
            print(f"{cell.name} {side} {k}: n={len(vs)} min={min(vs)!r} "
                  f"median={float(np.median(vs))!r} max={max(vs)!r}")


if __name__ == "__main__":
    main()
