"""The port's kernels as ``torch.library`` custom ops (namespace ``a8t``).

* ``torch.library.opcheck`` passes for every op's CPU implementation (the
  plain version), in float32 and, where the op takes it, bfloat16, the
  gradient ops included: the schema, the fake implementation against
  the real one, the autograd registration and ``aot_dispatch`` with
  dynamic shapes (``ops/samples.py`` has the inputs; ``chip_smoke.py``
  runs the same checks on the kernels).
* Every op has a ``cpu`` and a ``cuda`` kernel and a fake (``Meta``)
  implementation and no other device; no ``torch.autograd.Function``
  is left around a kernel.
* A fake run (a ``torch.export`` trace) counts no launch, and the public
  wrappers keep their results: each op's output equals the plain
  version's on the JAX package's reference inputs of the kernel tests.
"""
import inspect

import numpy as np
import pytest
import torch

from audio8_tpu_torch.ops import (adamw, attention, attention_block, conv,
                                  ctc, dropout)
from audio8_tpu_torch.ops.samples import F32_ONLY, OPS, run_opcheck, samples
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

CASES = [(name, dt) for name in OPS
         for dt in ((torch.float32,) if name in F32_ONLY
                    else (torch.float32, torch.bfloat16))]


@pytest.mark.parametrize("name,dtype", CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in CASES])
def test_opcheck_cpu(name, dtype):
    got = torch.library.opcheck(OPS[name], samples(name, "cpu", dtype))
    assert set(got) == {"test_schema", "test_autograd_registration",
                        "test_faketensor", "test_aot_dispatch_dynamic"}
    assert all(v == "SUCCESS" for v in got.values()), got


def test_ops_live_in_the_a8t_namespace():
    assert sorted(str(op._opoverload).split(".")[1] for op in OPS.values()) \
        == sorted(OPS)
    for name in OPS:
        packet = getattr(torch.ops.a8t, name)
        assert packet.default.namespace == "a8t"


@pytest.mark.parametrize("name", sorted(OPS))
def test_each_op_has_cpu_cuda_and_fake_and_nothing_else(name):
    qualified = f"a8t::{name}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(qualified, "CPU") and has(qualified, "CUDA")
    assert has(qualified, "Meta")  # the fake implementation
    for other in ("XPU", "MPS", "HIP", "CompositeImplicitAutograd",
                  "CompositeExplicitAutograd"):
        assert not has(qualified, other), other


def test_no_autograd_function_is_left_around_a_kernel():
    for module in (adamw, attention, attention_block, conv, ctc, dropout):
        for _, obj in inspect.getmembers(module, inspect.isclass):
            assert not issubclass(obj, torch.autograd.Function), (module,
                                                                  obj)


def test_fake_runs_count_no_launch():
    """A trace and an opcheck run only the fakes and the CPU versions:
    no wrapper counts a launch."""
    from audio8_tpu_torch.ops.conv import conv1d_k3s2

    counters = (conv1d_k3s2, conv.conv1d_k3s2_dgrad, conv.conv1d_k3s2_wgrad,
                attention.attention_core, attention.attention_core_bwd,
                dropout.fused_dropout, ctc.ctc_loss, adamw.adamw_update,
                attention_block.attention_block,
                attention_block.attention_block_bwd)
    before = [f.launches for f in counters]
    run_opcheck("cpu", ["conv_k3s2", "attention_core", "hash_dropout"])

    class Conv(torch.nn.Module):
        def forward(self, x, w):
            return conv1d_k3s2(x, w)

    x, w = torch.zeros(2, 41, 8), torch.zeros(3, 8, 8)
    program = torch.export.export(Conv(), (x, w))
    assert any("a8t.conv_k3s2" in str(n.target)
               for n in program.graph.nodes)
    assert [f.launches for f in counters] == before


def test_wrappers_keep_the_plain_results():
    """Through the ops, the public functions give their plain versions'
    bits (forward and gradient) on CPU tensors."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 23, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 8, 16)).astype(np.float32))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = conv.conv1d_k3s2(xg, wg)
    assert torch.equal(y, conv.conv1d_k3s2_plain(x, w))
    dy = torch.from_numpy(rng.normal(size=y.shape).astype(np.float32))
    y.backward(dy)
    assert torch.equal(xg.grad, conv.conv1d_k3s2_dgrad_plain(dy, w, 23))
    assert torch.equal(wg.grad, conv.conv1d_k3s2_wgrad_plain(x, dy))
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 9, 16)).astype(
        np.float32)) for _ in range(3))
    kv = torch.tensor([[True] * 9, [True] * 4 + [False] * 5])
    got = attention.attention_core(q, k, v, kv, 0.25, 0.2, 3, xla=True)
    assert torch.equal(got, attention.attention_core_plain(
        q, k, v, kv, 0.25, 0.2, 3, xla=True))
    assert torch.equal(dropout.fused_dropout(x, 0.3, 9),
                       dropout.hash_dropout(x, 0.3, 9))
