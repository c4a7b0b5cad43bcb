"""Command-line runner of the port (the ``cooling`` family so far).

    python -m mdqtplasmasims_torch.cli cooling --n0 3500 --tmax 30 \
        --save-directory dataLaserCool/ --job 1 --device cuda

Flags are generated from :class:`CoolingConfig` exactly as the JAX
package's ``mdqt cooling`` generates them; ``--device`` picks the torch
device (``cuda`` launches the hand-written kernels, ``cpu`` runs their
plain torch versions).
"""

from __future__ import annotations

import argparse
import sys
import time

from mdqtplasmasims_tpu.cli import _add_dataclass_args, _build_cfg


def main(argv=None) -> int:
    from .experiments import laser_cooling

    parser = argparse.ArgumentParser(prog="mdqt-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("cooling", help="flagship laser-cooling run")
    _add_dataclass_args(p, laser_cooling.CoolingConfig)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    ns = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    cfg = _build_cfg(laser_cooling.CoolingConfig, ns)
    t0 = time.perf_counter()
    laser_cooling.run(cfg, device=ns.device)
    print(f"[{ns.cmd}] done on {ns.device} in "
          f"{time.perf_counter() - t0:.1f}s"
          + (f" -> {cfg.save_directory}" if cfg.save_directory else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
