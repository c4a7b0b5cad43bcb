"""The benchmark of the PyTorch and CUDA port (``mdqtplasmasims_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, one process per run, on a machine with the
CUDA cards the cell asks for.  The cell's program is its workload's
driver (``benchmark/drivers/``): set-up (building or loading the kernels,
the cell's start from ``--seed``, a warm-up), then the window of
``--seconds`` over the driver's production loop, then the comparison of
what the window produced with the plain reference (``benchmark/reference/``).
The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (groups), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones, as ``BENCHMARK.json``
lists them), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each compared number beside its limit, which also end the
standard error.  Exits 2 without enough cards, and 3 if JAX or the JAX
package was loaded.
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

FORBIDDEN = ("jax", "jaxlib", "flax", "mdqtplasmasims_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(run: dict, metrics: list, trace: bool) -> dict:
    """The contract's last line from a verified run record."""
    import torch
    from harness import registry, trace as tr
    out = {}
    for m in metrics:
        v = registry.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = dict(value=v, unit=m["unit"])
    mesh = run["workload"].get("mesh")
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=mesh[0] * mesh[1] if mesh else 1,
                  memory_peak_bytes=run["memory_peak_bytes"])
    line = dict(correct=run["correct"], attempted=run["groups"],
                failed=run["failed"], metrics=out, device=device)
    if trace:
        b = run["breakdown"]
        device.update(busy_s=tr.busy_s(b), window_s=b["window_ms"] / 1e3)
        line["breakdown"] = dict(
            device_ops=[[o["name"], o["ms"] / 1e3] for o in
                        tr.top_ops(tr.device_ops(run["trace"]), 10)],
            idle_gaps=tr.idle_gaps(run["trace"]))
    line["checks"] = run["checks"]
    return line


def main(argv=None) -> int:
    os.environ.setdefault("USE_FLAX", "0")
    args = parse(argv)
    import torch
    from harness import cell, registry
    bench = registry.spec()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        print(f"cell {args.workload} needs {entry['chips']} CUDA device(s)",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as scratch:
        run, segments = cell.measure(args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda", T_START,
                                     scratch)
    cell.verify(run, segments, args.seed, "cuda")
    del segments
    line = result_line(run, registry.cell_metrics(bench, args.workload,
                                                  bool(args.trace)),
                       bool(args.trace))
    print(f"setup {run['setup_s']:.3f} s, window {run['wall_s']:.3f} s, "
          f"{run['groups']} groups, check {run['check_s']:.3f} s",
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
