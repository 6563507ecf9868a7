"""The benchmark of gcmiipy_tpu_torch: one run of one cell.

    python3 gcmbench/run.py --workload grey-flagship --seed 7 --seconds 30 \\
        --trace 0

run from the root of a checkout, on a machine with the cards the cell asks
for.  Prints the numbers compared and their limits as the last lines of
standard error, and the result as the last line of standard output: one
JSON object with ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` (with ``--trace 1`` also the device's busy and the traced
window's seconds), ``breakdown`` with ``--trace 1``, and ``checks`` last.
Exits non-zero, with no result, without a CUDA device, or where the JAX
package or JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host loop is the program's, and no
# thread pool of the benchmark's competes with it
os.environ.setdefault("OMP_NUM_THREADS", "1")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.chdir(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from gcmbench import bench

    loaded = bench.load_cell(args.workload, ROOT)
    chips = loaded["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gcmbench: needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, found = bench.run_cell(loaded, args.seed, args.seconds,
                                   trace=bool(args.trace), device="cuda",
                                   t_start=T_START)
    if found:
        print(f"gcmbench: loaded {', '.join(found)}: the benchmark runs "
              "without JAX and the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
