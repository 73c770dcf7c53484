"""``test_torch_serve_mesh_jax.py``'s checks at tp = 2 (the DiT split in
two): the port's server over two gloo ranks against the JAX ``JobRunner``
on the conftest's CPU mesh, at 5e-3 (one mesh a file keeps each file under
a minute).
"""

from test_torch_serve_mesh_jax import (  # noqa: F401 -- collected here at tp = 2
    runs,
    test_mesh_jobs_match_the_jax_job_runner,
)

AXES = {"tp2": dict(dp=1, tp=2)}
