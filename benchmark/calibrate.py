"""Readings the limits of a cell's comparison are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds s1,s2,.. \
        --seconds <s> --out <file.jsonl>

For each seed, in one process (the kernels built and loaded once): the
cell's set-up and window as ``run.py`` makes them, then the comparison of
the window's samples with the float64 reference (the program's numbers,
the lower readings) and of the reference computed in bfloat16 in the
program's place (the control's numbers, the upper readings).  One JSON
line per seed, appended to ``--out`` as it finishes.  Not run by the
benchmark's own runs.
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch
    from harness import cell, registry
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as scratch:
            run, segments = cell.measure(args.workload, seed, args.seconds,
                                         False, "cuda", t0, scratch)
        rate = registry.reader("updates_per_s")(run)
        cell.verify(run, segments, seed, "cuda", control=torch.bfloat16)
        del segments
        line = dict(workload=args.workload, seed=seed, program=run["worst"],
                    control=run["control"], correct=run["correct"],
                    groups=run["groups"], updates_per_s=rate,
                    setup_s=run["setup_s"], wall_s=run["wall_s"],
                    check_s=run["check_s"])
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
