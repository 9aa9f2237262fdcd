"""Solution visualization.

Capability parity with ``pycollo/vis/plot.py`` (105 LoC): interpolated
state/state-derivative/control curves with collocation-point markers, and
mesh-density bar plots.  Matplotlib is imported lazily so headless/compute
environments without a display never pay for it.
"""

from __future__ import annotations

import numpy as np


def _get_plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_solution(solution, n_interp: int = 200, show: bool = True,
                  save_path=None):
    """Plot states, state derivatives and controls per phase
    (``pycollo/vis/plot.py:17-77``)."""
    plt = _get_plt()
    num_phases = len(solution.phase_data)
    fig, axes = plt.subplots(3, num_phases, squeeze=False,
                             figsize=(6 * num_phases, 10))
    for i, pd in enumerate(solution.phase_data):
        tau_q = np.linspace(-1.0, 1.0, n_interp)
        y_q, u_q = solution.interpolate_phase(i, tau_q)
        t_q = pd.stretch * tau_q + pd.shift
        ax = axes[0][i]
        for j in range(pd.y.shape[0]):
            line, = ax.plot(t_q, y_q[j], label=f"y{j}")
            ax.plot(pd.time, pd.y[j], "x", color=line.get_color())
        ax.set_title(f"Phase {i}: states")
        ax.legend()
        ax = axes[1][i]
        for j in range(pd.dy.shape[0]):
            ax.plot(pd.time, pd.dy[j], marker="x", label=f"dy{j}")
        ax.set_title(f"Phase {i}: state derivatives")
        ax.legend()
        ax = axes[2][i]
        for j in range(pd.u.shape[0]):
            line, = ax.plot(t_q, u_q[j], label=f"u{j}")
            ax.plot(pd.time, pd.u[j], "x", color=line.get_color())
        ax.set_title(f"Phase {i}: controls")
        ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    if show:
        plt.show()
    return fig


def plot_mesh(solution, show: bool = True, save_path=None):
    """Mesh-density bar plot per phase (``pycollo/vis/plot.py:80-101``)."""
    plt = _get_plt()
    tables = solution.iteration.tables
    fig, axes = plt.subplots(1, len(tables), squeeze=False,
                             figsize=(6 * len(tables), 4))
    for i, t in enumerate(tables):
        ax = axes[0][i]
        sec_bounds = np.concatenate([t.tau[t.section_starts], [t.tau[-1]]])
        widths = np.diff(sec_bounds)
        density = (t.section_nodes - 1) / widths
        ax.bar(sec_bounds[:-1], density, width=widths, align="edge",
               edgecolor="k")
        ax.set_title(f"Phase {i}: mesh density (K={t.K}, N={t.N})")
        ax.set_xlabel("tau")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    if show:
        plt.show()
    return fig
