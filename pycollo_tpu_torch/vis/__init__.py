from .plot import plot_mesh, plot_solution  # noqa: F401
