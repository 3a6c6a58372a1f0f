"""pspde — path-space PDE solver framework in JAX.

A JAX/optax rebuild of the capabilities of
lorenzrichter/path-space-PDE-solver: high-dimensional parabolic and
elliptic PDEs (HJB, BSDE-type, eigenvalue, committor) solved via
path-space variational formulations over Euler-Maruyama trajectory
ensembles.  See SURVEY.md for the reference layer map this rebuilds.
"""

from . import ansatz, eval, losses, parallel, problems, rollout, solvers, utils

__version__ = "0.1.0"
