"""Parallelism across ranks (``audio8_tpu/parallel/``): data parallelism
in :mod:`audio8_tpu_torch.parallel.sharding`, ZeRO-1 and FSDP over the
data group in :mod:`~audio8_tpu_torch.parallel.zero`, tensor and sequence
parallelism over the model group in
:mod:`~audio8_tpu_torch.parallel.tensor`.

The trainers reach the last two through the three functions here, which
choose between them by the run's layout: tensor parallelism when a model
group runs (``sharding.py:make_groups``), else ZeRO-1/FSDP as the flags
ask. ``cli/common.py:check_ported`` refuses the two together."""
from __future__ import annotations

import contextlib


def shard_state(state, group, zero1: bool = False, fsdp: bool = False):
    """Split or shard a whole ``TrainState`` (restored, and broadcast over
    the data group ``group``): over the model group under tensor
    parallelism (``tensor.py:shard_state``, after one more broadcast from
    the model group's first rank), else ``zero.py:shard_state``."""
    from audio8_tpu_torch.parallel import tensor, zero
    from audio8_tpu_torch.parallel.sharding import sync_from_rank0

    mg = tensor.current_model_group()
    if mg is None:
        return zero.shard_state(state, group, zero1=zero1, fsdp=fsdp)
    sync_from_rank0(state.model, mg.group)
    return tensor.shard_state(state, mg)


def shard_like(module, state) -> None:
    """Split or shard ``module`` (data2vec's EMA teacher, a copy of the
    student) as ``state``'s model is."""
    from audio8_tpu_torch.parallel import tensor, zero

    tp = getattr(state, "tensor_shards", None)
    if tp is not None:
        tensor.shard_model(module, tp.mg)
    else:
        zero.shard_like(module, state)


@contextlib.contextmanager
def full_state(*objs):
    """The whole state of each split or sharded ``TrainState`` and module
    in ``objs`` for the block (``tensor.py:TensorShards.whole``,
    ``zero.py:full_state``); a collective that every rank enters."""
    from torch import nn

    from audio8_tpu_torch.parallel import zero

    with contextlib.ExitStack() as stack:
        rest = []
        for obj in objs:
            tp = getattr(obj, "tensor_shards", None)
            if tp is None:
                rest.append(obj)
            else:
                stack.enter_context(tp.whole(
                    None if isinstance(obj, nn.Module) else obj))
        stack.enter_context(zero.full_state(*rest))
        yield
