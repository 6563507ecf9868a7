"""How close each float32 polar filter comes to the float64 truth on the GPU.

    python -m gcmiipy_tpu_torch.filter_accuracy [--height 512 --width 1024
        --layers 9 --seed 2]

From a random state (the recipe of tests/test_pallas_fused.py:_initial) it
stacks the two fields one half step filters, ``[spu_raw; pg_phi]``
(``core25d.pgf_forces``), and filters them at float32 four ways: the FFT
(``torch.fft``), the banded DFT with float32 sums (``torch.matmul`` on
float32 factors), the banded DFT with float64 sums (the plain version of
K5, K6 and K7) and the hand-written FFT kernel with float64 sums (their
filter stage, ``ops/fft_filter.py``).  Each is held against the banded DFT
at float64 of the same float32 rows, so only the filter's own arithmetic
counts; the error is the largest over the field's scale, for the spu_raw
planes and the pg_phi planes apart.  Then one K6 step (``MegaStep``) at
float32 against the same step at float64 from the same float32 state and
geometry, per field.
Prints one JSON line, with the card's name.
"""

import argparse
import json

import torch

from gcmiipy_tpu_torch.device import resolve_device
from gcmiipy_tpu_torch.dynamics import core25d
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model.state import random_prognostics
from gcmiipy_tpu_torch.ops import fft_filter, mega_step, polar_filter


def scaled_err(out, ref):
    out, ref = out.double(), ref.double()
    return float((out - ref).abs().max() / ref.abs().max())


def measure(height, width, layers, seed, device, dt=30.0):
    g32 = geometry.gen_geometry(height, width, layers,
                                sig_func=geometry.manabe_sig,
                                dtype=torch.float32, device=device)
    g64 = g32.to(dtype=torch.float64)
    s32 = tuple(random_prognostics(g64, seed, torch.float32))
    s64 = tuple(x.double() for x in s32)
    L = layers

    x32 = torch.cat(core25d.pgf_forces(s32[0], s32[1], s32[3], g32)[:2])
    truth = mega_step.banded_filter_ref(x32.double(),
                                        mega_step.build_banded_consts(g64))
    bc32 = mega_step.build_banded_consts(g32)
    bc32_sums = bc32._replace(**{n: getattr(bc32, n).float()
                                 for n in ("CS", "CwSw", "mcc")})
    filters = {
        "fft float32": polar_filter.arakawa_1977(x32, g32),
        "dft float32 sums": mega_step.banded_filter_ref(x32, bc32_sums),
        "dft float64 sums": mega_step.banded_filter_ref(x32, bc32),
        "fft kernel float64 sums": fft_filter.fft_filter(
            x32.clone(), fft_filter.build_fft_consts(g32)),
    }
    out = {"filter": {name: {"spu_raw": scaled_err(y[:L], truth[:L]),
                             "pg_phi": scaled_err(y[L:], truth[L:])}
                      for name, y in filters.items()}}
    step_truth = mega_step.MegaStep(g64, dt)(*s64)
    step32 = mega_step.MegaStep(g32, dt)(*s32)
    out["mega_step float32 vs float64"] = {
        name: scaled_err(a, b) for name, a, b in zip("puvtq", step32,
                                                     step_truth)}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=9)
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    result = measure(args.height, args.width, args.layers, args.seed, device)
    result.update(grid=[args.layers, args.height, args.width], seed=args.seed,
                  device=torch.cuda.get_device_name(device))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
