"""Readings the limits of a cell's comparison are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds s1,s2,.. \
        --seconds <s> --out <file.jsonl>

For each seed, in one process (the kernels built and loaded once): the
cell's set-up and window as ``run.py`` makes them, its end-to-end metrics
as ``BENCHMARK.json`` gives them to it, then the comparison of what the
window followed with the reference (the program's numbers, the lower
readings) and of the control in the program's place (the control's
numbers, the upper readings), the control's dtype its driver's
``CONTROL``.  One JSON line per seed, appended to ``--out`` as it
finishes.  Not run by the benchmark's own runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def reading(workload: str, seed: int, seconds: float, device,
            t_start: float) -> dict:
    """One seed's line: the program's and the control's numbers, whether
    the run is correct, and the cell's end-to-end metrics."""
    from harness import cell, registry
    with tempfile.TemporaryDirectory() as scratch:
        run, followed = cell.measure(workload, seed, seconds, False, device,
                                     t_start, scratch)
    metrics = {m["name"]: registry.reader(m["name"])(run)
               for m in registry.cell_metrics(registry.spec(), workload,
                                              False)}
    control = cell.driver_of(workload, run["workload"]).CONTROL
    cell.verify(run, followed, seed, device, control=control)
    del followed
    return dict(workload=workload, seed=seed, program=run["worst"],
                control=run["control"], correct=run["correct"],
                groups=run["groups"], metrics=metrics,
                wall_s=run["wall_s"], check_s=run["check_s"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = reading(args.workload, seed, args.seconds, "cuda",
                       time.perf_counter())
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
