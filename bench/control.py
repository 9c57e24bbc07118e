"""Readings that set a cell's limits, on the chip. For each seed: the
program's numbers (set-up's checked steps, then the check, no window),
the control's (the reference computed in the precision below the one the
configuration states, in the program's place), or a fault's (the
program with its timed path broken underneath, ``bench/drivers``'
``faults``). One JSON line a reading, every number the cell can compare.

``python3 bench/control.py --workload <cell> --side program|control|<fault>
--seeds 1 2 3``
"""
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402


def readings(driver, cell, config, side: str, seed: int, dev) -> dict:
    from bench import tracing
    if side == "control":
        return driver.control_readings(cell, config, seed, dev)
    targets = [] if side == "program" else driver.faults(side)
    with tracing.patched(targets):
        sut = driver.setup(cell, config, seed, dev)
    return driver.check_readings(sut)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", default="program")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from bench import harness
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, config = harness.load_cell(args.workload)
    driver = importlib.import_module(f"bench.drivers.{cell['driver']}")
    dev = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(driver, cell, config, args.side, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": args.side,
                          "seconds": time.perf_counter() - t0,
                          "numbers": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
