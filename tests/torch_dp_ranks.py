"""Gloo ranks on the CPU for the data-parallel tests
(``tests/test_torch_dp_*.py``): :func:`run_ranks` spawns ``world``
processes, joins them in a gloo group through a ``file://`` rendezvous
under the test's ``tmp_path`` and returns each rank's result; the step
runners (:func:`ctc_steps`, :func:`pretrain_steps`, :func:`ppl_grads`,
:func:`moe_layers`) run on a rank (``group`` the process group) or, with
``group`` None and ``world`` 1, in the calling process on the whole
batch. A spawn costs each rank a fresh import of torch, so a test file
spawns once: :func:`several` runs a list of runners on one spawn, and
:func:`run_cli_ranks` a list of CLI runs. This module imports torch and
the port only: the spawned ranks never import JAX."""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

# SGD: a parameter moves by its gradient, so parameters compare as well
# as gradients do (AdamW normalises a rounding-level gradient, an
# attention key bias's, into a step of the learning rate)
LR = 1e-2


def _offsets() -> tuple:
    from audio8_tpu_torch.utils import Offsets

    return ((Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK),
            list(Offsets.VALUES))


def _set_offsets(offsets) -> None:
    from audio8_tpu_torch.utils import Offsets

    (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK), values = offsets
    Offsets.VALUES[:] = values


def _entry(rank, world, init_file, out_dir, worker, args, offsets):
    _set_offsets(offsets)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = worker(rank, world, dist.group.WORLD, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(worker, world: int, tmp_path, *args) -> list:
    """``worker(rank, world, group, *args)`` on ``world`` spawned gloo
    ranks, which start with the caller's special-token ids; their
    results in rank order."""
    import torch.multiprocessing as mp

    out_dir = str(tmp_path)
    mp.start_processes(_entry, args=(world, os.path.join(out_dir, "init"),
                                     out_dir, worker, args, _offsets()),
                       nprocs=world, start_method="spawn", join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(world)]


def several(rank, world, group, jobs):
    """Each ``(worker, args)`` of ``jobs`` in turn on this rank (one
    spawn for several runs); their results in order."""
    return [worker(rank, world, group, *args) for worker, args in jobs]


def _state(model):
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)

    return TrainState(model, create_optimizer(
        create_lrs(LR, 10, sched_type="constant", warmup_steps=0), "sgd"))


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def ctc_steps(rank, world, group, cfg, params, batch, seed_lists):
    """CTC steps (unfrozen, summed loss) on rank ``rank``'s row block of
    ``batch`` (numpy), one step per list of replayed dropout seeds;
    returns the global losses, the gradient norms and the parameters."""
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.ops.hashrand import SeedReplay
    from audio8_tpu_torch.parallel.sharding import (global_sum_scalars,
                                                    row_block)
    from audio8_tpu_torch.train.steps import make_ctc_steps

    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg))
    model.load_state_dict(params, strict=True)
    state = _state(model)
    grad_fn, update_fn, _ = make_ctc_steps(model, clip=25.0, group=group)
    n_real = int((batch["signal_lengths"] > 0).sum())
    lo, b_local, _ = row_block(n_real, batch["signal"].shape[0], rank,
                               world)
    local = {k: torch.from_numpy(v[lo:lo + b_local])
             for k, v in batch.items()}
    local["row_offset"] = lo
    losses, gnorms = [], []
    for seeds in seed_lists:
        replay = SeedReplay(seeds)
        loss, grads, rows, _ = grad_fn(local, replay, freeze=False)
        if replay.remaining:
            raise RuntimeError(f"{replay.remaining} seeds not drawn")
        state, gnorm = update_fn(state, grads, rows)
        losses.append(float(global_sum_scalars([float(loss)], group)[0]))
        gnorms.append(float(gnorm))
    return {"loss": losses, "gnorm": gnorms, "params": _params(model)}


def pretrain_steps(rank, world, group, cfg, params, signal, step_seeds):
    """Contrastive pretraining steps on rank ``rank``'s rows of the dense
    ``signal``; ``step_seeds``: per step ``(dropout seeds, (mask, gumbel,
    negatives))``. Returns the losses, gradient norms, code perplexities,
    accuracies and the parameters."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
    from audio8_tpu_torch.ops.hashrand import SeedReplay
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    model = Wav2Vec2Model(PretrainConfig(**cfg))
    model.load_state_dict(params, strict=True)
    state = _state(model)
    step, _ = make_pretrain_steps(model, clip=1.0,
                                  n_negatives=cfg["n_negatives"],
                                  group=group)
    b_local = signal.shape[0] // world
    lo = rank * b_local
    x = torch.from_numpy(signal[lo:lo + b_local])
    out = {k: [] for k in ("loss", "gnorm", "ppl", "accuracy")}
    for drop, (mask, gumbel, negatives) in step_seeds:
        replay = SeedReplay(drop)
        state, m = step(state, x, PretrainSeeds(mask=mask, gumbel=gumbel,
                                                negatives=negatives),
                        replay, lo)
        if replay.remaining:
            raise RuntimeError(f"{replay.remaining} seeds not drawn")
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["grad_norm"]))
        out["ppl"].append(float(m["code_perplexity"]))
        out["accuracy"].append(float(m["accuracy"]))
    out["params"] = _params(model)
    return out


def ppl_grads(rank, world, group, cfg, params, signal, seeds):
    """The gradient of the code perplexity alone (a global reduction of
    the batch's averaged probabilities) on rank ``rank``'s rows, summed
    over the ranks as a step sums its gradients."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
    from audio8_tpu_torch.ops.hashrand import SeedReplay
    from audio8_tpu_torch.parallel.sharding import (all_reduce_grads,
                                                    data_parallel)

    drop, (mask, gumbel, negatives) = seeds
    model = Wav2Vec2Model(PretrainConfig(**cfg))
    model.load_state_dict(params, strict=True)
    b_local = signal.shape[0] // world
    lo = rank * b_local
    with data_parallel(group, lo):
        _, _, ppl, _ = model(torch.from_numpy(signal[lo:lo + b_local]),
                             PretrainSeeds(mask, gumbel, negatives),
                             generator=SeedReplay(drop))
        ppl.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    if group is not None:
        all_reduce_grads(grads, group)
    return {"ppl": float(ppl.detach()), "grads": grads}


def _cli_entry(rank, world, port, out_dir, jobs, offsets):
    """One ``torchrun``-style rank of CLI runs: the environment
    ``torchrun`` sets, then each job's entry point with ``--distributed
    true``, each from the calling process's special-token ids, in one
    process group."""
    import importlib

    from audio8_tpu_torch.parallel import full_state

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        for i, (module, argv) in enumerate(jobs):
            _set_offsets(offsets)
            state = importlib.import_module(module).train(
                argv + ["--distributed", "true"])
            if isinstance(state, tuple):  # data2vec: (state, teacher)
                state = state[0]
            with full_state(state):  # whole parameters, every rank
                params = _params(state.model)
            torch.save({"log": state.log, "params": params,
                        "valid": getattr(state, "valid", None)},
                       os.path.join(out_dir, f"job{i}_rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_cli_ranks(jobs: list, world: int, tmp_path) -> list:
    """Each job ``(module, argv)``'s ``module.train(argv +
    ["--distributed", "true"])``, in turn on the same ``world`` spawned
    ranks over gloo (a free localhost port); per job, each rank's step
    log, validation rows and parameters."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.makedirs(tmp_path, exist_ok=True)
    out_dir = str(tmp_path)
    mp.start_processes(_cli_entry,
                       args=(world, port, out_dir, jobs, _offsets()),
                       nprocs=world, start_method="spawn", join=True)
    return [[torch.load(os.path.join(out_dir, f"job{i}_rank{r}.pt"))
             for r in range(world)] for i in range(len(jobs))]


def subdir(root, name):
    """``root / name``, made."""
    path = root / name
    path.mkdir()
    return path


@contextlib.contextmanager
def kept_offsets():
    """The port's special-token ids as they were on entry, once the block
    ends (a corpus fixture may remap them)."""
    saved = _offsets()
    try:
        yield
    finally:
        _set_offsets(saved)


def moe_layers(rank, world, group, cases):
    """One MoE layer (``nn.moe.MoEFFN``) forward and backward per case
    ``(cfg, params, x, weight)`` on rank ``rank``'s rows of ``x`` (B, T,
    d): its outputs, the aux, the input's gradient and the parameters'
    gradients summed over the ranks, of ``sum(y * weight) + aux``, each
    expert's kept tokens and the rows of this rank's expert table."""
    from audio8_tpu_torch.nn.moe import MoEFFN, capacity, route, table_rows
    from audio8_tpu_torch.parallel.sharding import (all_reduce_grads,
                                                    data_parallel,
                                                    global_sum_scalars)

    out = []
    for cfg, params, x, weight in cases:
        layer = MoEFFN(**cfg)
        layer.load_state_dict(params, strict=True)
        b_local = x.shape[0] // world
        lo = rank * b_local
        xl = torch.from_numpy(x[lo:lo + b_local]).requires_grad_()
        with data_parallel(group, lo):
            y, aux = layer(xl)
            loss = (y * torch.from_numpy(weight[lo:lo + b_local])).sum() \
                + aux
            loss.backward()
            with torch.no_grad():
                s = xl.shape[0] * xl.shape[1]
                probs = torch.softmax(
                    layer.router(xl.reshape(s, -1).float()), dim=-1)
                cap = capacity(s * world, cfg["num_experts"], cfg["top_k"],
                               cfg["capacity_factor"])
                slots, _ = route(probs, cfg["top_k"], cap)
        rows = table_rows(cap, s)
        kept = [[int(((idx == e) & (pos < rows)).sum()) for e in
                 range(cfg["num_experts"])] for idx, pos in slots]
        grads = {n: p.grad for n, p in layer.named_parameters()}
        if group is not None:
            all_reduce_grads(grads, group)
        kept = global_sum_scalars([k for row in kept for k in row], group)
        out.append({"y": y.detach(), "aux": float(aux.detach()),
                    "dx": xl.grad,
                    "grads": grads, "kept": kept.tolist(), "cap": cap,
                    "rows": rows})
    return out
