"""Data parallelism across ranks: the data-parallel half of
``audio8_tpu/parallel/sharding.py`` and the JAX trainers' ``--distributed``
(``audio8_tpu/cli/common.py:setup``), on torch ranks under ``torchrun``.

The JAX mesh runs one global-batch program: every device holds a block
of rows, and XLA inserts the gradient sums. Here each rank is a process
that drives one card (``torchrun --nproc_per_node N``), holds the
contiguous row block of the same global batch (the datasets' row-block
contract, :func:`row_block`), and the step makes the global program's
numbers from its rows:

- the hash draws (dropout, the attention kernels' masks, span masks,
  Gumbel noise, negatives) take the block's first global row
  (:func:`row_offset`, set by :func:`data_parallel` around a step), so
  every rank draws the global batch's bits;
- a quantity that sums over the batch (a denominator, the perplexity's
  averaged probabilities, the MoE load-balance means) is summed over the
  ranks by :func:`global_sum`, whose backward is the identity: each rank
  computes the same global value, differentiates only through its own
  rows, and the ranks' gradients summed (:func:`all_reduce_grads`) are
  the global program's. An all-reduce as the backward would count such
  a term once per rank;
- the gradients are summed, not averaged: the steps already scale by
  the global row and token counts. They are summed with explicit
  collectives over one flat buffer per dtype, not by
  ``DistributedDataParallel``, which averages and does not expect the
  zero gradients a frozen leaf gets here (``train/steps.py:_take_grads``).

Single process (no group) every function here is the identity, and a
step computes exactly what it computed before.

Tensor parallelism (``--tensor_parallel tp``, ``parallel/tensor.py``)
makes the ranks two-dimensional, as JAX's ``make_mesh`` reshapes its
devices to ``(data, model)``: rank ``r`` is data rank ``r // tp`` and
model rank ``r % tp``, so a model group is ``tp`` consecutive ranks
(:func:`setup` builds both kinds of group). Every function above that
counts rows (the row block, the datasets' shards, :func:`global_sum`,
:func:`gather_rows`, :func:`global_sum_scalars`, :func:`all_reduce_grads`
and the MoE counts) takes the **data** group (:func:`data_group`, what
the entry points pass as their ``group``): the model ranks of one data
rank hold the same rows, and a sum over the world would count each row
``tp`` times.
"""
from __future__ import annotations

import contextlib
import logging
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("audio8_tpu_torch")


# ------------------------------------------------------------- start-up


def dp_device(name: str, distributed: bool) -> str:
    """``--device`` under ``--distributed``: ``cuda`` is the card of this
    rank, ``cuda:$LOCAL_RANK`` (``torchrun`` sets it); an explicit
    ``cuda:N`` raises, since the launcher, not the flag, places ranks.
    Without ``--distributed`` the name is returned as it is."""
    if not distributed or not os.environ.get("WORLD_SIZE"):
        return name
    device = torch.device(name)
    if device.type == "cuda":
        if device.index is not None:
            raise ValueError(f"--device {name} under --distributed: each "
                             "rank takes cuda:$LOCAL_RANK; pass --device "
                             "cuda")
        return f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return name


class _Mesh:
    """The ranks' layout: ``tp`` model ranks per data rank, this rank's
    data and model groups (None without a process group)."""
    tp = 1
    data = None
    model = None


_MESH = _Mesh()


def make_groups(tp: int = 1) -> None:
    """Lay the running group's ranks out as ``(data, model)`` with ``tp``
    model ranks (the counterpart of ``make_mesh``): every rank builds
    every group, in one order. Raises, naming the flag, when ``tp`` does
    not divide the ranks. At ``tp`` 1 the data group is the whole world
    and there is no model group."""
    world = dist.get_world_size()
    tp = max(int(tp), 1)
    if world % tp:
        raise ValueError(f"model-parallel extent {tp} (--tensor_parallel) "
                         f"does not divide the {world} ranks")
    _MESH.tp, _MESH.data, _MESH.model = tp, dist.group.WORLD, None
    if tp == 1:
        return
    rank = dist.get_rank()
    for d in range(world // tp):
        ranks = [d * tp + m for m in range(tp)]
        group = dist.new_group(ranks)
        if rank in ranks:
            _MESH.model = group
    for m in range(tp):
        ranks = [d * tp + m for d in range(world // tp)]
        group = dist.new_group(ranks)
        if rank in ranks:
            _MESH.data = group


def data_group():
    """The data-parallel group of this rank (the world at
    ``--tensor_parallel`` 1), None without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return _MESH.data or dist.group.WORLD


def model_group():
    """The model (tensor-parallel) group of this rank, None below
    ``--tensor_parallel`` 2 or without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return _MESH.model


def setup(distributed: bool, device: Union[torch.device, str] = "cuda",
          backend: Optional[str] = None,
          tensor_parallel: int = 1) -> Tuple[int, int]:
    """Start the process group of a ``--distributed`` run; returns
    ``(rank, world)`` of the data-parallel layout: this rank's data rank
    and the data extent (the ranks over ``tensor_parallel``, whose model
    groups :func:`make_groups` builds). The counterpart of
    ``audio8_tpu/cli/common.py:setup`` and ``setup_parallelism``: it reads
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``MASTER_ADDR``/``MASTER_PORT`` as ``torchrun`` sets them and calls
    ``init_process_group``, NCCL for a CUDA ``device`` and gloo for the
    CPU (``backend`` overrides that; no flag sets it). Without those
    variables it warns and runs one rank, as JAX does; with
    ``WORLD_SIZE`` set it never falls back to one rank. Once the group
    runs, rank 0 logs at INFO and the others at WARN; without one the
    logging is left as it is."""
    env = os.environ
    rank, world = 0, 1
    _MESH.tp, _MESH.data, _MESH.model = 1, None, None
    if distributed and env.get("WORLD_SIZE"):
        missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT")
                   if not env.get(k)]
        if missing:
            raise RuntimeError(f"--distributed: WORLD_SIZE is set but "
                               f"{missing} are not (launch with torchrun)")
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            dist.init_process_group(
                backend or ("nccl" if device.type == "cuda" else "gloo"),
                init_method="env://", rank=rank, world_size=world)
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError("--distributed: the process group disagrees "
                               "with RANK / WORLD_SIZE")
        logging.basicConfig(
            level=logging.INFO if rank == 0 else logging.WARN,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s",
            force=True)
        logger.info("process %d/%d", rank, world)
        make_groups(tensor_parallel)
        tp = _MESH.tp
        if tp > 1:
            logger.info("tensor parallel: data rank %d/%d, model rank %d/%d",
                        rank // tp, world // tp, rank % tp, tp)
        return rank // tp, world // tp
    elif distributed:
        logger.warning("--distributed requested but no torchrun "
                       "environment (WORLD_SIZE) is set; training one rank")
    if tensor_parallel > 1:
        raise ValueError(f"model-parallel extent {tensor_parallel} "
                         "(--tensor_parallel) does not divide the 1 ranks: "
                         "launch --tensor_parallel ranks or more with "
                         "torchrun and --distributed true")
    return rank, world


def world_group():
    """The default process group when one is running, else None (the
    step factories' single-process path)."""
    return dist.group.WORLD if dist.is_available() and \
        dist.is_initialized() else None


def row_block(n_real: int, b_global: int, rank: int,
              world: int) -> Tuple[int, int, int]:
    """The JAX row-block contract (``audio8_tpu/data/datasets.py``): a
    global batch of ``b_global`` rows (a multiple of ``world``), the real
    ones first and the padding rows at the global tail, is cut into
    ``world`` contiguous blocks. Returns ``(row_offset, b_local,
    n_here)``: rank ``rank``'s first global row, its row count, and how
    many of its rows are real."""
    if b_global % world:
        raise ValueError(f"global batch {b_global} is not a multiple of "
                         f"the {world} ranks")
    b_local = b_global // world
    lo = rank * b_local
    return lo, b_local, min(max(n_real - lo, 0), b_local)


def barrier(group) -> None:
    """Wait for every rank of ``group`` (nothing without one)."""
    if group is not None:
        dist.barrier(group=group)


def group_root(group) -> int:
    """The global rank of ``group``'s rank 0 (a collective's ``src``)."""
    return dist.get_global_rank(group, 0) if group is not None and \
        group is not dist.group.WORLD else 0


# ------------------------------------------------- the step's context


class _Context:
    group = None
    row_offset = 0


_CONTEXT = _Context()


@contextlib.contextmanager
def data_parallel(group, row_offset: int = 0):
    """Run a step's forward and backward as rank ``group.rank()``'s block
    of a global batch whose first local row is global row ``row_offset``:
    :func:`row_offset` and :func:`global_sum` read it (also on autograd's
    threads, for a recomputed layer). ``group`` None: one process, the
    offset still applies (a test's row block)."""
    saved = (_CONTEXT.group, _CONTEXT.row_offset)
    _CONTEXT.group, _CONTEXT.row_offset = group, int(row_offset)
    try:
        yield
    finally:
        _CONTEXT.group, _CONTEXT.row_offset = saved


def row_offset() -> int:
    """The global row of the current step's first local row (0 outside a
    data-parallel step)."""
    return _CONTEXT.row_offset


def active_group():
    """The current step's process group, None outside one."""
    return _CONTEXT.group


class _GlobalSum(torch.autograd.Function):
    """All-reduce sum forward, identity backward (the module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the current step (the identity
    outside one); differentiable with an identity backward."""
    group = _CONTEXT.group
    return x if group is None else _GlobalSum.apply(x, group)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows in rank order forward; backward, this rank's
    block of the gradient (the other ranks' rows carry none here)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[0]
        return per_rank(x.detach(), group).reshape(-1, *x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.n
        return grad[lo:lo + ctx.n], None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of ``x`` (batch-first, the same row count
    on every rank) in the current step, with only this rank's rows
    carrying gradient (CLIP's B_global x B_global similarities); ``x``
    itself outside a step."""
    group = _CONTEXT.group
    return x if group is None else _GatherRows.apply(x, group)


def is_rank0() -> bool:
    """Whether this process is rank 0 of the current step (True outside
    one): a parameter that every rank differentiates in full (CLIP's
    ``logit_scale``) takes its gradient on rank 0 only, so the ranks'
    sum counts it once."""
    group = _CONTEXT.group
    return group is None or dist.get_rank(group) == 0


# ------------------------------------------------------- collectives


def _flat_groups(tensors: Sequence[torch.Tensor]):
    by_key: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        by_key.setdefault((t.dtype, t.device), []).append(t)
    return by_key.values()


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks: a new tensor in ``x``'s dtype, ``x``
    left as it was. NCCL sums in its own order; another backend (gloo,
    the test transport) sums a floating-point tensor in float64 and
    rounds once, so each element's sum is the same wherever it lies in
    the buffer and in whatever order the ranks add: the data-parallel,
    ZeRO-1, FSDP and tensor-parallel steps then agree bitwise at any
    world size (at two ranks this is gloo's sum in ``x``'s dtype, bit for
    bit; a bf16 row-split partial's sum is the bf16 sum of the rounded
    partials, as JAX's psum)."""
    if shard_route(group) == "native" or not x.is_floating_point():
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y
    wide = x.to(torch.float64, copy=True)
    dist.all_reduce(wide, group=group)
    return wide.to(x.dtype)


def all_reduce_grads(grads: Union[Dict[str, torch.Tensor],
                                  Sequence[torch.Tensor]],
                     group=None):
    """Sum a step's gradients over the ranks, in place: one flat buffer
    per dtype and device, one all-reduce each (after the backward, once
    per optimizer update under gradient accumulation). Returns
    ``grads``."""
    tensors = list(grads.values()) if isinstance(grads, dict) \
        else list(grads)
    for ts in _flat_groups(tensors):
        flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in ts]),
                              group)
        offset = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
    return grads


def collective_device(group=None) -> torch.device:
    """Where a host value must lie for the group's collectives: the
    current card under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_sum_scalars(values: Iterable[float], group=None) -> np.ndarray:
    """Sum a few host numbers over the ranks (validation counts, the
    logged loss, rows and tokens); the counterpart of ``sharding.py:246``.
    The identity without a process group; every rank must call it."""
    values = np.asarray(list(values), np.float64)
    if group is None:
        return values
    t = torch.from_numpy(values).to(collective_device(group))
    dist.all_reduce(t, group=group)
    return t.cpu().numpy()


def per_rank(value: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``value`` stacked in rank order, ``(world, *shape)``:
    one all-gather."""
    out = [torch.empty_like(value) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, value.contiguous(), group=group)
    return torch.stack(out)


def rank_prefix(counts: torch.Tensor, group) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``(sum of counts over the ranks before this one, sum over all
    ranks)`` of a small integer tensor: where this rank's tokens start in
    the global batch's order (the MoE slot numbering)."""
    every = per_rank(counts, group)
    return every[:dist.get_rank(group)].sum(0), every.sum(0)


def world_of(group) -> int:
    """The group's rank count (1 without a group)."""
    return 1 if group is None else dist.get_world_size(group)


# ----------- the sharded collectives (zero.py, tensor.py; all_reduce_sum)

_ROUTES: Dict[object, str] = {}


def shard_route(group) -> str:
    """How :func:`all_reduce_sum`, :func:`reduce_scatter_sum` and
    :func:`all_gather_flat` run over ``group``, chosen once per group by
    its backend and logged: ``native`` under NCCL (``all_reduce``,
    ``reduce_scatter_tensor``, ``all_gather_into_tensor``), else
    ``composed``: the all-reduce in float64, the reduce-scatter an
    all-reduce of the whole buffer and this rank's slice of it, the
    all-gather gloo's list all-gather (bf16 moved as int16), which all
    take CUDA tensors (staged through the host)."""
    route = _ROUTES.get(group)
    if route is None:
        backend = dist.get_backend(group)
        route = "native" if backend == "nccl" else "composed"
        _ROUTES[group] = route
        logger.info("sharded collectives over %s: %s", backend,
                    "reduce_scatter_tensor, all_gather_into_tensor"
                    if route == "native" else
                    "all-reduce in float64, "
                    "reduce-scatter = all_reduce + this rank's slice, "
                    "all-gather = all_gather into the buffer's slices")
    return route


# the names torch gives these collectives since 2.13 (the older ones warn)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    getattr(dist, "reduce_scatter_tensor", None)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    getattr(dist, "all_gather_into_tensor", None)


def reduce_scatter_sum(flat: torch.Tensor, group) -> torch.Tensor:
    """This rank's ``1/world`` slice of ``flat`` (1-D, a multiple of the
    world size long) summed over the ranks: a new tensor. Sums, never
    averages, as :func:`all_reduce_grads`. ``flat`` is left as it was."""
    world, rank = world_of(group), dist.get_rank(group)
    c = flat.numel() // world
    if c * world != flat.numel():
        raise ValueError(f"reduce_scatter_sum: {flat.numel()} elements "
                         f"over {world} ranks")
    if shard_route(group) == "native":
        out = flat.new_empty(c)
        _REDUCE_SCATTER(out, flat.contiguous(), group=group)
        return out
    summed = all_reduce_sum(flat, group)
    return summed[rank * c:(rank + 1) * c].clone()


def all_gather_flat(chunk: torch.Tensor, group,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's ``chunk`` (1-D, the same length on every rank)
    concatenated in rank order, into ``out`` when given (which ``chunk``
    must not alias) or a new tensor."""
    world = world_of(group)
    if out is None:
        out = chunk.new_empty(chunk.numel() * world)
    if out.numel() != chunk.numel() * world:
        raise ValueError(f"all_gather_flat: {chunk.numel()} x {world} "
                         f"into {out.numel()}")
    if shard_route(group) == "native":
        _ALL_GATHER(out, chunk.contiguous(), group=group)
    else:  # gloo moves bytes: bf16 travels as int16
        bits = (lambda t: t.view(torch.int16)) \
            if chunk.dtype == torch.bfloat16 else (lambda t: t)
        dist.all_gather(list(bits(out).chunk(world)),
                        bits(chunk.contiguous()), group=group)
    return out


def checksum(module: torch.nn.Module) -> int:
    """An integer checksum of ``module``'s parameters' bits (the sum of
    their 32-bit words): equal parameters give equal checksums."""
    total = 0
    for p in module.parameters():
        words = p.detach().contiguous().reshape(-1)
        words = words.view(torch.int32) if words.element_size() == 4 \
            else words.view(torch.uint8)
        total += int(words.to(torch.int64).sum())
    return total


def sync_from_rank0(module: torch.nn.Module, group=None) -> int:
    """Broadcast rank 0's parameters and buffers to every rank, then
    check by :func:`checksum` that every rank holds the same parameters
    (raises if not). Returns the checksum."""
    if group is None:
        return checksum(module)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=group_root(group), group=group)
    mine = checksum(module)
    sums = per_rank(torch.tensor(mine, dtype=torch.int64,
                                 device=collective_device(group)), group)
    if len(set(sums.tolist())) != 1:
        raise RuntimeError(f"ranks hold different parameters after the "
                           f"broadcast: checksums {sums.tolist()}")
    return mine


# --------------------------------------------------------------- dry run


def _dryrun_batch(world: int):
    """A global CTC batch of ``2 * world`` rows, its last row all
    padding (the batch-size snap's filler), and the tiny model's
    config."""
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.utils import Offsets

    rng = np.random.default_rng(0)
    b, t, u, v = 2 * world, 2400, 5, 12
    lengths = rng.integers(1200, t + 1, size=b).astype(np.int32)
    lengths[-1] = 0
    signal = rng.normal(size=(b, t)).astype(np.float32)
    signal[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    tok_len = np.where(lengths > 0, u, 0).astype(np.int32)
    tokens = rng.integers(4, v, size=(b, u)).astype(np.int32)
    tokens[np.arange(u)[None, :] >= tok_len[:, None]] = Offsets.PAD
    cfg = AcousticConfig(num_labels=v, d_model=32, num_heads=2, num_layers=2,
                         d_ff=64, custom_conv_features=((16, 10, 5),
                                                        (16, 3, 2)),
                         dropout=0.1, attention_dropout=0.1,
                         timestep_masking=0.3, timestep_mask_len=4,
                         channel_masking=0.1, channel_mask_len=4,
                         freeze_fx=False)
    return {"signal": signal, "signal_lengths": lengths,
            "token_ids": tokens, "token_lengths": tok_len}, cfg


def _dryrun_step(rank: int, world: int, group, n_ranks: int):
    """One CTC step of the dry run's model on rank ``rank``'s block of
    the ``n_ranks``-rank batch; returns the parameters after it and the
    summed loss."""
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)
    from audio8_tpu_torch.train.steps import make_ctc_steps

    batch, cfg = _dryrun_batch(n_ranks)
    b_global = batch["signal"].shape[0]
    n_real = int((batch["signal_lengths"] > 0).sum())
    lo, b_local, _ = row_block(n_real, b_global, rank, world)
    local = {k: torch.from_numpy(v[lo:lo + b_local]) for k, v in
             batch.items()}
    local["row_offset"] = lo
    model = Wav2Vec2AcousticModel(cfg, generator=torch.Generator()
                                  .manual_seed(0))
    # SGD: the parameters move by the gradient itself (AdamW would scale
    # the rounding noise of a zero gradient, an attention key bias's, up
    # to a full step)
    state = TrainState(model, create_optimizer(create_lrs(
        1e-3, 10, sched_type="constant", warmup_steps=0), "sgd"))
    grad_fn, update_fn, _ = make_ctc_steps(model, group=group)
    loss, grads, rows, _ = grad_fn(local, torch.Generator().manual_seed(7),
                                   freeze=False)
    update_fn(state, grads, rows)
    loss = float(global_sum_scalars([float(loss)], group)[0])
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, \
        loss


def _dryrun_worker(rank: int, world: int, init_file: str, out_dir: str,
                   offsets: tuple):
    from audio8_tpu_torch.utils import Offsets

    (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK), values = offsets
    Offsets.VALUES[:] = values
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        params, loss = _dryrun_step(rank, world, world_group(), world)
        torch.save({"params": params, "loss": loss},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, tol: float = 1e-5) -> dict:
    """The port's counterpart of ``__graft_entry__.py:dryrun_multichip``:
    ``n`` gloo ranks on the CPU (spawned processes) take one CTC training
    step of a tiny model, dropout and masks on, on their blocks of a
    global batch whose last row is padding; the result must equal one
    rank's step on the whole batch within ``tol`` (parameters, absolute)
    and the ranks' parameters must be bitwise equal. Raises if not;
    returns ``{"loss", "loss_one_rank", "max_param_diff"}``."""
    import tempfile

    import torch.multiprocessing as mp

    from audio8_tpu_torch.utils import Offsets

    # every rank starts with this process's special-token ids
    offsets = ((Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK),
               list(Offsets.VALUES))
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_dryrun_worker,
                           args=(n, os.path.join(tmp, "init"), tmp, offsets),
                           nprocs=n, start_method="spawn", join=True)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(n)]
    one, loss_one = _dryrun_step(0, 1, None, n)
    for r in ranks[1:]:
        for k, v in r["params"].items():
            if not torch.equal(v, ranks[0]["params"][k]):
                raise RuntimeError(f"dryrun_multichip({n}): rank parameters "
                                   f"differ at {k}")
    diff = max(float((v - one[k]).abs().max())
               for k, v in ranks[0]["params"].items())
    if diff > tol or not np.isclose(ranks[0]["loss"], loss_one, rtol=1e-5):
        raise RuntimeError(f"dryrun_multichip({n}): {n} ranks differ from "
                           f"one rank by {diff:.3g} (loss "
                           f"{ranks[0]['loss']} vs {loss_one})")
    return {"loss": ranks[0]["loss"], "loss_one_rank": loss_one,
            "max_param_diff": diff}
