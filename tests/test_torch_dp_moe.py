"""The Mixture-of-Experts FFN under data parallelism: two gloo ranks,
each with half the rows of a batch, route as one process routes the
whole batch. The capacity counts the global tokens, each expert's slots
are numbered in the global row-major order (so the same tokens are kept
when the capacity drops some), and the load-balance aux is the global
batch's; the ranks' outputs together are one process's, and their
summed gradients (of the outputs' weighted sum plus the aux, which
every rank computes whole) are one process's, not twice the aux's. A
rank's expert table holds its own kept tokens only: at most its tokens
where the capacity is larger (the last case). One pair of ranks runs
every case. Tolerances: outputs and aux 1e-6 (the same per-token
arithmetic; the aux's means sum in another order), gradients rtol
1e-5."""
import numpy as np
import pytest
import torch

from audio8_tpu_torch.nn.moe import MoEFFN
from tests.test_torch_threads import cap_torch_threads
from tests.torch_dp_ranks import moe_layers, run_ranks

cap_torch_threads()

CASES = [(1, 1.25), (2, 0.5), (2, 1.1)]


def _case(top_k, capacity_factor):
    cfg = dict(d_model=16, d_ff=32, num_experts=4, top_k=top_k,
               capacity_factor=capacity_factor)
    layer = MoEFFN(**cfg)
    layer.init_from(torch.Generator().manual_seed(0))
    with torch.no_grad():  # a router that prefers some experts: drops
        layer.router.weight.copy_(torch.randn(
            layer.router.weight.shape,
            generator=torch.Generator().manual_seed(1)) * 2.0)
    params = {k: v.detach().clone() for k, v in layer.state_dict().items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 9, 16)).astype(np.float32)
    weight = rng.normal(size=(4, 9, 16)).astype(np.float32)
    return cfg, params, x, weight


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = [_case(*c) for c in CASES]
    return (moe_layers(0, 1, None, cases),
            run_ranks(moe_layers, 2, tmp_path_factory.mktemp("moe"), cases))


@pytest.mark.parametrize("top_k,capacity_factor", CASES)
def test_two_ranks_route_as_one(runs, top_k, capacity_factor):
    i = CASES.index((top_k, capacity_factor))
    one, two = runs[0][i], [r[i] for r in runs[1]]
    assert sum(one["kept"]) < 4 * 9 * top_k  # the capacity dropped tokens
    assert two[0]["kept"] == two[1]["kept"] == one["kept"]
    assert one["rows"] == one["cap"] == two[0]["cap"]
    assert two[0]["rows"] == min(two[0]["cap"], 2 * 9)
    assert two[0]["aux"] == two[1]["aux"]
    np.testing.assert_allclose(two[0]["aux"], one["aux"], rtol=1e-6)
    torch.testing.assert_close(torch.cat([r["y"] for r in two]), one["y"],
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.cat([r["dx"] for r in two]),
                               one["dx"], rtol=1e-5, atol=1e-7)
    for k, g in one["grads"].items():
        assert torch.equal(two[0]["grads"][k], two[1]["grads"][k]), k
        torch.testing.assert_close(two[0]["grads"][k], g, rtol=1e-5,
                                   atol=1e-7, msg=k)

