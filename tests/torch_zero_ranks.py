"""Step runners for the ZeRO-1 and FSDP tests (``tests/test_torch_zero*.py``)
on the gloo ranks of ``tests/torch_dp_ranks.py``: each builds a tiny model
from given weights, shards its AdamW state over the rank's group
(``parallel/zero.py:shard_state``, ``mode`` one of ``dp``, ``zero1``,
``fsdp``), takes steps on the rank's row block and returns the global
losses, gradient norms, the whole parameters and moments (read in
``zero.full_state`` on every rank) and the elements the rank stores. With
``group`` None and ``world`` 1 they run the plain step in the calling
process. This module imports torch and the port only."""
from __future__ import annotations

import torch

from tests.torch_dp_ranks import _params

LR = 1e-3


def adamw_state(model, lr: float = LR, weight_decay: float = 0.01,
                optim: str = "adamw", sched: str = "constant"):
    """A TrainState over ``model``: AdamW (or ``optim``) at ``lr`` under
    the ``sched`` schedule of 100 steps, no warmup."""
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)

    return TrainState(model, create_optimizer(
        create_lrs(lr, 100, sched_type=sched, warmup_steps=0), optim,
        weight_decay))


def whole(state, group) -> dict:
    """The whole parameters and AdamW moments of ``state`` (every rank
    enters ``full_state``), and the elements this rank stores."""
    from audio8_tpu_torch.parallel.zero import full_state

    stored = state.shards.stored(state) if state.shards is not None else {
        "params": sum(p.numel() for p in state.params),
        "moments": 2 * sum(p.numel() for p in state.params), "grads": 0}
    with full_state(state):
        params = _params(state.model)
        mu = {n: m.detach().clone() for n, m in
              zip(state.names, getattr(state.opt_state, "mu", ()))}
        nu = {n: v.detach().clone() for n, v in
              zip(state.names, getattr(state.opt_state, "nu", ()))}
    return {"params": params, "mu": mu, "nu": nu, "stored": stored}


def ctc_run(rank, world, group, cfg, params, batch, steps, mode,
            seed: int = 7, grad_accum: int = 1, state_kw=None):
    """``steps`` AdamW CTC steps (unfrozen, dropout from a generator
    seeded ``seed`` on every rank) on rank ``rank``'s row block of
    ``batch`` (numpy), the state sharded as ``mode`` says; each step takes
    ``grad_accum`` micro-steps on the same block."""
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.parallel.sharding import (global_sum_scalars,
                                                    row_block)
    from audio8_tpu_torch.parallel.zero import shard_state
    from audio8_tpu_torch.train.steps import accumulate_grads, make_ctc_steps

    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg))
    model.load_state_dict(params, strict=True)
    state = adamw_state(model, **(state_kw or {}))
    shard_state(state, group, zero1=mode == "zero1", fsdp=mode == "fsdp")
    grad_fn, update_fn, eval_fn = make_ctc_steps(model, clip=25.0,
                                                 group=group)
    n_real = int((batch["signal_lengths"] > 0).sum())
    lo, b_local, _ = row_block(n_real, batch["signal"].shape[0], rank,
                               world)
    local = {k: torch.from_numpy(v[lo:lo + b_local])
             for k, v in batch.items()}
    local["row_offset"] = lo
    gen = torch.Generator().manual_seed(seed)
    losses, gnorms = [], []
    for _ in range(steps):
        acc, rows_sum, loss_sum = None, 0.0, 0.0
        for _ in range(grad_accum):
            loss, grads, rows, _ = grad_fn(local, gen, freeze=False)
            acc = accumulate_grads(acc, grads)
            rows_sum += float(rows)
            loss_sum += float(loss)
        state, gnorm = update_fn(state, acc, rows_sum)
        losses.append(float(global_sum_scalars([loss_sum], group)[0]))
        gnorms.append(float(gnorm))
    eval_loss, _, _ = eval_fn(local)
    out = whole(state, group)
    out.update(loss=losses, gnorm=gnorms, eval_loss=float(global_sum_scalars(
        [float(eval_loss)], group)[0]))
    return out


def pretrain_run(rank, world, group, cfg, params, signal, steps, mode,
                 seed: int = 11):
    """``steps`` AdamW contrastive pretraining steps (dropout 0.1 and the
    span masks drawn from a generator seeded ``seed`` on every rank) on
    rank ``rank``'s rows of the dense ``signal``."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
    from audio8_tpu_torch.parallel.zero import shard_state
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    model = Wav2Vec2Model(PretrainConfig(**cfg))
    model.load_state_dict(params, strict=True)
    state = adamw_state(model)
    shard_state(state, group, zero1=mode == "zero1", fsdp=mode == "fsdp")
    step, _ = make_pretrain_steps(model, clip=1.0,
                                  n_negatives=cfg["n_negatives"],
                                  group=group)
    b_local = signal.shape[0] // world
    lo = rank * b_local
    x = torch.from_numpy(signal[lo:lo + b_local])
    gen = torch.Generator().manual_seed(seed)
    losses, gnorms = [], []
    for _ in range(steps):
        state, m = step(state, x, PretrainSeeds.draw(gen), gen, lo)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    out = whole(state, group)
    out.update(loss=losses, gnorm=gnorms)
    return out


def _close(a, b, atol: float, where: str) -> None:
    """``a`` equals ``b`` (nested dicts, lists, tensors, numbers), tensors
    within ``atol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _close(a[k], b[k], atol, f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, atol, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.shape == b.shape and a.dtype == b.dtype, where
        if a.is_floating_point() and a.numel():
            assert float((a - b).abs().max()) <= atol, where
        else:
            assert torch.equal(a, b), where
    elif isinstance(a, float):
        assert abs(a - b) <= atol * max(1.0, abs(b)), where
    else:
        assert a == b, where


def same_saves(mine, dp, atol: float = 1e-6) -> list:
    """Every ``.pt`` and resume file of the run directory ``dp`` is in
    ``mine``, equal within ``atol`` (parameters, moments; counts and steps
    exactly); returns the names compared."""
    import os

    names = sorted(n for n in os.listdir(dp)
                   if n.endswith((".pt", ".resume")))
    assert names and sorted(n for n in os.listdir(mine)
                            if n.endswith((".pt", ".resume"))) == names
    for n in names:
        _close(torch.load(os.path.join(mine, n), weights_only=False),
               torch.load(os.path.join(dp, n), weights_only=False), atol, n)
    return names


def close_logs(mine: list, dp: list, rtol: float = 1e-6) -> None:
    """Two ranks' step logs: the same steps, every loss within ``rtol``
    of the data-parallel run's."""
    assert [r["step"] for r in mine] == [r["step"] for r in dp]
    for a, b in zip(mine, dp):
        assert abs(a["loss"] - b["loss"]) <= rtol * abs(b["loss"]), (a, b)


def _sigterm_entry(rank, world, port, out_dir, jobs, offsets, sender):
    """``torch_dp_ranks._cli_entry``, with rank ``sender`` sending itself
    SIGTERM as its trainer starts (once ``PreemptionGuard`` holds it)."""
    import os
    import signal

    from audio8_tpu_torch.train import preempt
    from tests.torch_dp_ranks import _cli_entry

    init = preempt.PreemptionGuard.__init__

    def guarded(self, group=None):
        init(self, group)
        if rank == sender:
            os.kill(os.getpid(), signal.SIGTERM)

    preempt.PreemptionGuard.__init__ = guarded
    _cli_entry(rank, world, port, out_dir, jobs, offsets)


def run_cli_ranks_sigterm(jobs: list, world: int, tmp_path, sender: int,
                          timeout: float) -> list:
    """``torch_dp_ranks.run_cli_ranks`` with a SIGTERM on rank ``sender``
    at the start of each job; raises ``TimeoutError`` (after killing the
    ranks) if they have not all ended within ``timeout`` seconds."""
    import os
    import socket
    import time

    import torch.multiprocessing as mp

    from tests.torch_dp_ranks import _offsets

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.makedirs(tmp_path, exist_ok=True)
    ctx = mp.start_processes(_sigterm_entry,
                             args=(world, port, str(tmp_path), jobs,
                                   _offsets(), sender),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")
    return [[torch.load(os.path.join(tmp_path, f"job{i}_rank{r}.pt"))
             for r in range(world)] for i in range(len(jobs))]
