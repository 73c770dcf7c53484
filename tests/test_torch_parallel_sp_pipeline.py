"""The port's pipeline at tp x sp = 2 x 2 (four gloo ranks on the CPU): a
2-step prediction, its token stream striped over sp and its heads over tp,
against the port's unsharded run (2e-4) and the JAX pipeline on the same
mesh, as ``test_torch_parallel_pipeline.py`` holds its cases."""

import pytest
import torch

from test_torch_parallel_pipeline import check_case, run_cases

torch.set_num_threads(1)

CASES = {"prediction_tp2_sp2": (dict(dp=1, tp=2, sp=2), "prediction")}


@pytest.fixture(scope="module")
def setup():
    return run_cases(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_sp_pipeline_matches_unsharded_and_jax(setup, name):
    check_case(setup, CASES, name)
