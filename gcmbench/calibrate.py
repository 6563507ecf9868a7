"""The readings a cell's comparison limits are set from, at the cell's own
size, on the card:

    python3 gcmbench/calibrate.py --workload grey-flagship [--out FILE]

The sound readings: every member of the configuration's pool (every start
that any seed's run holds) run by the program through its run function,
as the window runs it, every interval against the float64 reference run
over that interval from the program's state at its start (the check's
form), and its start against the reference's own; their largest is a
limit's lower end.  Then the broken paths of ``gcmbench/faults.py`` (the
bfloat16 control, whose smallest reading is a limit's upper end, and the
faults) on the pool's first three members.  One JSON line per member and
kind on standard output (and in ``--out``): the worst and the least
reading over its intervals, then the summary.  The benchmark's own runs
never run this.
"""

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BROKEN_MEMBERS = (0, 1, 2)


def calibrate(loaded, device="cuda", sound=None, broken=BROKEN_MEMBERS,
              emit=None):
    """The readings of the cell ``loaded`` (:func:`gcmbench.bench.load_cell`),
    as a list of the records ``main`` prints: the program on the pool
    members ``sound`` (all by default), each broken path on ``broken``."""
    import torch
    from gcmbench import bench, faults, members
    from gcmbench.reference import model as ref_model

    config, traffic = loaded["config"], loaded["traffic"]
    readings, records = {}, []

    def record(rec):
        rec = dict(workload=loaded["cell"]["name"], **rec)
        records.append(rec)
        if emit:
            emit(rec)

    pool = members.Pool(config["perturbation"], config["model"]["layers"],
                        traffic["height"], traffic["width"], device)
    program = bench.Program(config, traffic, pool, device)
    n_int = traffic["member_steps"] // traffic["interval_steps"]
    ref = ref_model.Reference(config["model"], traffic["height"],
                              traffic["width"], traffic["dt"],
                              dtype=torch.float64, device=device)
    base = ref.start(config["start"] == "moist")

    def fields(st):
        return {f: x.clone() for f, x in bench.program_fields(st).items()}

    def member(runner, index):
        """Pool member ``index`` run by ``runner`` (a program or a broken
        one): its start and every interval's input, output, energy and
        guard, as the window keeps a sampled one."""
        st = runner.start(index)
        start, kept = fields(st), []
        for k in range(n_int):
            one = dict(step=k * traffic["interval_steps"],
                       input=fields(st))
            st, ok, e = runner.read(runner.run(st))
            one.update(output=fields(st), energy=e, ok=ok)
            kept.append(one)
            if not ok:
                break
        return start, kept

    kinds = [("program", program, i)
             for i in (range(pool.size) if sound is None else sound)]
    for name, fault in faults.FAULTS.items():
        broken_program = copy.copy(program)
        fault(broken_program)
        kinds += [(name, broken_program, i) for i in broken]
    for kind, runner, index in kinds:
        t = time.perf_counter()
        start, kept = member(runner, index)
        secs = time.perf_counter() - t
        ref.sweeps = ref_model.Sweeps()
        start_gap = bench.field_gap(start, bench.perturbed_start(
            ref, base, pool, index))
        gaps, bad, t = [], False, time.perf_counter()
        for one in kept:
            g, b = bench.interval_gaps(ref, one, traffic)
            g["start_gap"] = start_gap
            bad = bad or b
            gaps.append(g)
        readings.setdefault(kind, []).append(gaps)
        record(dict(kind=kind, member=index,
                    worst={k: max(g[k] for g in gaps) for k in gaps[0]},
                    least={k: min(g[k] for g in gaps) for k in gaps[0]},
                    program_ok=all(k["ok"] for k in kept),
                    intervals=len(kept), reference_bad=bad,
                    most_sweeps=ref.sweeps.most, program_seconds=secs,
                    reference_seconds=time.perf_counter() - t))
        del kept
    record(dict(kind="summary", min_max={
        kind: {k: [min(g[k] for r in rs for g in r),
                   max(g[k] for r in rs for g in r)] for k in rs[0][0]}
        for kind, rs in readings.items()}))
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from gcmbench import bench
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()

    calibrate(bench.load_cell(args.workload, ROOT), emit=emit)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
