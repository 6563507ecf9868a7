"""Run harnesses with stability guards.

Port of ``gcmiipy_tpu/model/harness.py``, the twin of the reference's
interactive runners ``run_1d_with_ft`` / ``run_2d_with_ft`` (reference
``just_units.py:298-340``, ``two_d.py:306-346``) and
``run_shallow_with_bed`` (reference ``primitive_1d.py:164-187``), without
matplotlib.  JAX runs the steps under ``lax.scan``; here a Python loop
runs them with the guard kept on the device: the ``ok`` flag is a 0-dim
bool tensor and the freeze a ``torch.where`` over each leaf of the state
(a nest of tuples, lists and dicts, walked as ``jax.tree`` walks it), so
that no step reads anything back to the host.
"""

import torch

from gcmiipy_tpu_torch.diagnostics import courant_number, get_total_variation


def _leaves(tree):
    """The tensors of a (possibly nested) tuple, namedtuple, list or dict,
    in the order of ``jax.tree.leaves``: dict keys sorted, None empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _map(fn, tree, *rest):
    """``fn`` over the matching leaves of ``tree`` and the trees of the same
    structure in ``rest`` (``jax.tree.map``); the structure is kept, a
    dict's keys in sorted order, as JAX rebuilds it."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((key, _map(fn, tree[key], *(r[key] for r in rest)))
                          for key in sorted(tree))
    if isinstance(tree, (tuple, list)):
        items = [_map(fn, *xs) for xs in zip(tree, *rest)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def run_guarded(step_fn, state, steps, variation_of=None, variation_slack=1e3,
                collect=None):
    """Run ``step_fn`` (state -> state) ``steps`` times.

    ``variation_of``: function state -> tensor whose total variation is
    guarded (the reference's guard: fail when the total variation grows
    past its initial value plus ``variation_slack`` or a NaN appears,
    just_units.py:327-332); by default the state's first leaf.  Once
    tripped, the state freezes, so that a blow-up cannot overflow into inf
    arithmetic.

    The state may be any nest of tuples, namedtuples, lists and dicts of
    tensors, as JAX's pytrees; so may what ``collect`` returns.

    Returns ``(final_state, stable, history)``: ``stable`` a 0-dim bool
    tensor, ``history`` the ``collect(state)`` of every step with each leaf
    stacked along a new first axis (the structure that ``lax.scan`` gives),
    or None.
    """
    if variation_of is None:
        variation_of = lambda s: _leaves(s)[0]  # noqa: E731

    initial_tv = get_total_variation(variation_of(state))
    ok = torch.ones((), dtype=torch.bool, device=initial_tv.device)
    history = []
    for _ in range(steps):
        s_next = step_fn(state)
        field = variation_of(s_next)
        fine = ((get_total_variation(field) <= initial_tv + variation_slack)
                & ~torch.isnan(field).any())
        ok = ok & fine
        state = _map(lambda new, old: torch.where(ok, new, old), s_next, state)
        if collect:
            history.append(collect(state))
    if not collect:
        return state, ok, None
    return state, ok, _map(lambda *xs: torch.stack(xs), *history)


def run_shallow_with_bed(count, func, h, u, b, dt, dx):
    """Shallow-water-over-bed runner with Courant monitoring
    (reference primitive_1d.py:164-187).

    Returns ``(h, u, stable, max_courant)``, tensors.
    """
    def step(state):
        h, u = state
        return func(h, u, b, dt, dx)

    def collect(state):
        h, u = state
        return courant_number(h, u, dx, dt)

    (h, u), stable, courants = run_guarded(
        step, (h, u), count, variation_of=lambda s: s[0], collect=collect)
    return h, u, stable, torch.max(courants)
