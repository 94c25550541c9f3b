"""ipde_tpu: spectral solver framework for inhomogeneous elliptic
PDEs (Poisson, modified Helmholtz, Stokes) on general smooth domains.

A ground-up JAX/XLA re-design with the capabilities of the reference package
dbstein/ipde (see SURVEY.md at the repo root for the blueprint).
"""
from ipde_tpu import config  # noqa: F401  (enables x64 on import)

__version__ = "0.1.0"
