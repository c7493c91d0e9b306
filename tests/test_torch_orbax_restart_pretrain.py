"""The pretraining half of ``tests/test_torch_orbax_restart.py``'s
resumes, on the CPU: under ``adamw``, ``fused_adamw`` and ``sgd``, JAX
trains 3 steps and saves its Orbax ``TrainState``, the port restores it
whole and trains 2 more, within the trajectory tolerances of JAX's 5
(the port replaying each JAX step's seeds); the port trains 3 steps, its
``.pt`` and resume file become an Orbax ``TrainState``
(``cli.convert_checkpoint``'s ``to_orbax``), JAX restores it whole and
trains 2 more, within the tolerances of the port's 5. A file of its own
so that the two halves' JAX compiles run on two test workers."""
import pytest

from tests.test_torch_orbax_restart import (OPTIMS, PretrainRun,
                                            resume_both_ways)
from tests.test_torch_orbax_restart import \
    _fairseq_offsets  # noqa: F401 - a fixture
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(scope="module")
def run():
    return PretrainRun()


@pytest.mark.parametrize("optim", OPTIMS)
def test_pretrain_resumes_both_ways(run, optim, tmp_path):
    resume_both_ways(run, optim, tmp_path)
