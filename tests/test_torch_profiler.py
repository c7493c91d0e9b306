"""``--profile_dir``: the port's ``StepProfiler`` (``train/profiler.py``,
``torch.profiler`` where the JAX package uses ``jax.profiler``) over a
tiny CPU training step, on the CPU.

* The window opens at ``step(start)`` and closes at ``step(start +
  num)``: no file before, one parseable Chrome trace after, holding one
  ``ProfilerStep#`` span per traced step and the step's ops (an
  ``annotate`` region, a matmul's ``aten::mm``), and nothing written by
  later steps.
* The JAX defaults: start 10, 5 steps.
* ``close()`` ends an open window and writes its trace; without a
  directory nothing is traced.
"""
import json
import os

import torch

from audio8_tpu_torch.train.profiler import StepProfiler, annotate
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


def _tiny_step(model, opt):
    with annotate("tiny_step"):
        loss = model(torch.randn(4, 8)).square().mean()
        loss.backward()
        opt.step()
        opt.zero_grad()


def _run(profiler, steps):
    """``steps`` tiny steps, ``profiler.step`` after each; the directory's
    files after each step."""
    torch.manual_seed(0)
    model = torch.nn.Linear(8, 8)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    seen = []
    for step in range(1, steps + 1):
        _tiny_step(model, opt)
        profiler.step(step)
        seen.append(sorted(os.listdir(profiler.trace_dir))
                    if os.path.isdir(profiler.trace_dir) else [])
    return seen


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_window_writes_one_trace(tmp_path):
    prof = StepProfiler(str(tmp_path / "trace"), start_step=2, num_steps=3)
    seen = _run(prof, 8)
    name = "trace-steps-2-5.json"
    assert seen[:4] == [[], [], [], []]  # nothing before the window ends
    assert all(s == [name] for s in seen[4:])  # one file, none after
    events = _events(prof.path)
    steps = {e["name"] for e in events
             if e.get("name", "").startswith("ProfilerStep#")}
    assert steps == {"ProfilerStep#0", "ProfilerStep#1", "ProfilerStep#2"}
    names = [e.get("name") for e in events]
    assert names.count("tiny_step") == 3 and "aten::mm" in names


def test_jax_defaults_and_close(tmp_path):
    prof = StepProfiler(str(tmp_path))
    assert (prof.start, prof.stop) == (10, 15)
    seen = _run(prof, 12)
    assert seen[-1] == []  # the window is open
    prof.close()
    assert os.path.basename(prof.path) == "trace-steps-10-15.json"
    names = [e.get("name") for e in _events(prof.path)]
    assert names.count("tiny_step") == 2
    prof.close()  # a closed window stays closed


def test_no_directory_no_trace():
    prof = StepProfiler(None, start_step=0)
    prof.step(0)
    prof.close()
    assert prof.path is None
