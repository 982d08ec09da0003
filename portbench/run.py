"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA cards the cell
asks for. ``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1``
its per-layer metrics, read from the same timed window and from a shorter
window under the device profiler that follows it. The last line
of standard output is one JSON object; the numbers that decide ``correct``
are the last lines of standard error and the result's last key.
"""

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from portbench import harness
    return harness.main(args, root)


if __name__ == "__main__":
    sys.exit(main())
