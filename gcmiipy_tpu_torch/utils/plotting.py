"""Save-to-file plots of fields and energy traces.

Port of ``gcmiipy_tpu/utils/plotting.py``.  The reference drives
interactive matplotlib imshow and energy plots from every driver (reference
``no_limits_2_5d.py:131``, ``test_geography.py:26-37``,
``matsumo_temp.py:110-129``); headless runs render them to PNG instead.
matplotlib is imported when a plot is made, with the Agg backend, so that
the port runs where it is not installed; fields on the card are copied to
the host first.  :func:`make_field_plot_callback` fits ``run_model``'s
``callback=`` hook.
"""

import os

import numpy as np
import torch


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_field_plot(field, path, title=None, cmap="viridis"):
    """imshow of a [j, i] field (or the first level of [k, j, i]) to
    ``path`` (the reference's ``plot_callback`` imshow,
    test_geography.py:26-37)."""
    plt = _plt()
    field = _host(field)
    if field.ndim == 3:
        field = field[0]
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(field, cmap=cmap, aspect="auto")
    fig.colorbar(im, ax=ax)
    if title:
        ax.set_title(title)
    ax.set_xlabel("longitude index")
    ax.set_ylabel("latitude index")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def save_energy_plot(stats, path, fields=("ke", "ate", "geo",
                                          "total_energy")):
    """Per-step energy traces from a stacked ``StepStats`` (the reference's
    STATS energy plot, no_limits_2_5d.py:85-91 / test_geography.py:30-37)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    for name in fields:
        y = _host(getattr(stats, name)).astype(np.float64)
        ax.plot(y / max(abs(y[0]), 1e-300), label=name)
    ax.set_xlabel("step")
    ax.set_ylabel("energy / |initial|")
    ax.legend()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def make_field_plot_callback(out_dir, every=10, field="p", prefix="step"):
    """A ``run_model(callback=...)`` hook saving a PNG every ``every`` steps."""
    idx = {"p": 0, "u": 1, "v": 2, "t": 3, "q": 4}[field]
    counter = {"n": 0}

    def callback(*prog):
        n = counter["n"]
        counter["n"] += 1
        if n % every:
            return
        save_field_plot(prog[idx],
                        os.path.join(out_dir, f"{prefix}_{n:06d}_{field}.png"),
                        title=f"{field} at step {n}")

    return callback
