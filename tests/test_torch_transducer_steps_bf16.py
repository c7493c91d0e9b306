"""The 10-step bf16 RNN-T trajectory of the port against the JAX
package's on the CPU (3 frozen steps, then unfrozen; the helpers and
weights of ``test_torch_transducer_steps.py``): loss rtol 5e-3, as the
CTC and pretraining bf16 trajectories of ``test_torch_bf16.py``.
"""
import numpy as np

from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_transducer_steps import (_fairseq_offsets, params,
                                               trajectories)

cap_torch_threads()
__all__ = ["_fairseq_offsets", "params"]  # the fixtures this file uses


def test_bf16_trajectory(params):
    t = trajectories(params, bf16=True)
    np.testing.assert_allclose(t["loss"], t["j_loss"], rtol=5e-3)
    assert t["loss"][-1] < t["loss"][0]
