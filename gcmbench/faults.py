"""Broken timed paths, for showing that the check fails them: each takes
the set-up :class:`gcmbench.bench.Program` and puts a broken path in the
place of its own.

* ``control``: the control, the plain reference computed in bfloat16 (the
  precision below the configuration's float32) in the program's place:
  its own start of each member, and each interval run from the state it
  is handed;
* ``unchanged``: the call returns the state it was given (with that
  state's own stats), as a step that does nothing would;
* ``altered``: the call's answer is altered where it is produced: u at one
  point of the lowest layer moved by a tenth of the field's largest
  magnitude, in every interval's output.
"""

from types import SimpleNamespace

import torch


def control(program):
    from gcmbench import bench
    from gcmbench.reference import model as ref_model
    config, tr = program.config, program.traffic
    ref = ref_model.Reference(config["model"], tr["height"], tr["width"],
                              tr["dt"], dtype=torch.bfloat16,
                              device=program.device)
    base = ref.start(config["start"] == "moist")

    def as_program(state, s):
        fields = {f: getattr(s, f).to(state.prog.p.dtype)
                  for f in bench.FIELDS}
        prog = state.prog._replace(
            **{f: fields[f] for f in state.prog._fields})
        ground = state.ground._replace(
            **{f: fields[f] for f in state.ground._fields})
        return state._replace(prog=prog, ground=ground)

    def start(index):
        s = bench.perturbed_start(ref, base, program.pool, index)
        state = program.base
        return as_program(state._replace(utc=state.utc.clone(),
                                         step=state.step.clone()), s)

    def run(state):
        n = int(state.step) - int(program.base.step)
        s, energy, bad = bench.reference_interval(
            ref, bench.program_fields(state), n, tr)
        steps = tr["interval_steps"]
        new = as_program(state._replace(utc=state.utc + steps * tr["dt"],
                                        step=state.step + steps), s)
        like = state.prog.p
        return (new, SimpleNamespace(total_energy=torch.tensor(
                    [energy], dtype=torch.float64, device=like.device)),
                SimpleNamespace(ok=torch.tensor(not bad, device=like.device)))

    program.start, program.run = start, run


def unchanged(program):
    from gcmiipy_tpu_torch.model import driver
    run, geom = program.run, program.geom

    def broken(state):
        _, _, guard = run(state)
        stats = driver.collect_stats(state, geom)
        return state, type(stats)(*(x[None] for x in stats)), guard
    program.run = broken


def altered(program):
    run = program.run

    def broken(state):
        new, stats, guard = run(state)
        u = new.prog.u.clone()
        _, h, w = u.shape
        u[0, h // 2, w // 2] += 0.1 * u.abs().max()
        return new._replace(prog=new.prog._replace(u=u)), stats, guard
    program.run = broken


FAULTS = {"control": control, "unchanged": unchanged, "altered": altered}
