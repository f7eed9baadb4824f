"""A train state laid out over a mesh: shards, gathers and gradient
reductions (the counterpart of the JAX package's ``place_train_state`` and of
the collectives GSPMD inserts from the shardings).

``ParallelLayout`` follows ``sharding_rules.train_state_specs``:

  - replicated: every rank holds every parameter and Adam moment; after the
    backward the gradients are averaged over the data axis with all-reduces
    of flat buckets, in the parameters' order (the same reduction order on
    every step, so a resumed run repeats the bits of an uninterrupted one);
  - FSDP (ZeRO-3): a leaf split over ``data`` is stored as this rank's
    shard, with its Adam moments; it is all-gathered into the module's
    parameter before the forward, and its gradient is reduce-scattered after
    the backward;
  - tensor parallelism: a conv or dense layer whose output channels split
    over ``model`` holds only this rank's O/m output channels and runs
    column-parallel: the identity on its input forward (an all-reduce of the
    input's gradient over ``model`` backward, since each rank's channels
    carry only their part of it), then the all-gather of the output channels
    along C forward (this rank's slice of the gradient backward); a conv's
    row shift (``Conv2d(x, row=...)``, a resnet's time embedding) is split
    as its output channels are. The rest of the network runs whole, the
    same on every model rank, so GroupNorm+SiLU sees the whole tensor and
    K1/K2 run at their one-rank shapes. A GroupNorm scale or bias split over
    ``model`` is all-gathered before the forward, as an FSDP leaf is.

The global gradient norm for the clip sums each leaf's squared norm over
the ranks that split it. Loss and gradients are the one-rank step's on the
global batch up to the order of a sum.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from baddiffusion_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, RowSharding, axis
from baddiffusion_tpu_torch.parallel.sharding_rules import train_state_specs

BUCKET_ELEMENTS = 1 << 25  # elements of one flat all-reduce bucket (128 MiB in f32)


def all_gather_dim(t: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ranks' shards of ``dim`` concatenated in rank order."""
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """This rank's chunk of ``dim`` of the sum over the ranks."""
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def all_reduce_flat(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, as flat buckets of at most
    ``BUCKET_ELEMENTS`` in their order (a fixed order: the same bits on every
    rank and every step)."""
    start = 0
    while start < len(tensors):
        end, n = start, 0
        while end < len(tensors) and (end == start or n + tensors[end].numel() <= BUCKET_ELEMENTS):
            n += tensors[end].numel()
            end += 1
        bucket = tensors[start:end]
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(v.view(t.shape))
        start = end


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over the model axis
    backward (each rank's output channels carry their part of the input's
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the last (channel) dim over the model axis forward, into
    a contiguous tensor; this rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, y, group, size, index):
        ctx.index, ctx.c = index, y.shape[-1]
        x = y.contiguous()
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out.view((size,) + tuple(x.shape)).movedim(0, -2).reshape(tuple(x.shape[:-1]) + (size * ctx.c,))

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.index * ctx.c:(ctx.index + 1) * ctx.c].contiguous(), None, None, None


class ParallelLayout:
    """How a train state of ``model`` lies over ``mesh``, and the collectives
    a step needs for it (module docstring). Building it turns the wide conv
    and dense layers of ``model`` column-parallel when the mesh has a model
    axis above 1; build the train state before it (``create_train_state``),
    then ``place_train_state`` splits that state into this rank's shards.
    ``batch`` is the rows of each global batch this rank trains on."""

    def __init__(self, mesh, model: nn.Module, param_sharding: str = "replicated", grad_accum: int = 1,
                 tp_threshold: int = 256, fsdp_min_size: int = 2**16):
        self.mesh = mesh
        self.data_group, self.data_size, self.data_rank = axis(mesh, DATA_AXIS)
        self.model_group, self.model_size, self.model_rank = axis(mesh, MODEL_AXIS)
        self.batch = RowSharding(self.data_group, self.data_rank, self.data_size, grad_accum)
        self.specs = train_state_specs(model, self.data_size, self.model_size, param_sharding, tp_threshold,
                                       fsdp_min_size)["params"]
        self.names = list(self.specs)
        self.full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters() if n in self.specs}
        self.sharded = any(a is not None for spec in self.specs.values() for a in spec)
        # conv and dense layers whose weight splits its output channels over the model axis
        self.column_parallel = sorted({n.rpartition(".")[0] for n, spec in self.specs.items()
                                       if n.endswith(".weight") and len(spec) in (2, 4) and spec[0] == MODEL_AXIS})
        self._hooks = {}
        for name in self.column_parallel:
            self._install(model.get_submodule(name), name)
        self.model = model
        params = dict(model.named_parameters())
        self.working = [params[n] for n in self.names]

    # ---- specs ----
    def _dims(self, name: str):
        spec = self.specs[name]
        model_dim = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
        data_dim = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
        return model_dim, data_dim, name.rpartition(".")[0] in self.column_parallel

    def _install(self, module: nn.Module, name: str) -> None:
        m, idx, group = self.model_size, self.model_rank, self.model_group
        for leaf in ("weight", "bias"):
            p = getattr(module, leaf, None)
            if p is None:
                continue
            if p.shape[0] % m:
                raise ValueError(f"{name}.{leaf}: {p.shape[0]} output channels do not split over {m} model ranks")
            setattr(module, leaf, nn.Parameter(p.detach().chunk(m, 0)[idx].clone(), requires_grad=p.requires_grad))

        def column_input(mod, args, kwargs):
            row = kwargs.get("row")
            if row is not None:
                kwargs = dict(kwargs, row=_CopyToModel.apply(row, group).chunk(m, -1)[idx].contiguous())
            return (_CopyToModel.apply(args[0], group),) + args[1:], kwargs

        pre = module.register_forward_pre_hook(column_input, with_kwargs=True)
        post = module.register_forward_hook(lambda mod, args, out: _GatherFromModel.apply(out, group, m, idx))
        self._hooks[name] = (pre.id, post.id)

    # ---- shards ----
    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's stored shard of a whole parameter (or Adam moment)."""
        model_dim, data_dim, _ = self._dims(name)
        t = full
        if model_dim is not None:
            t = t.chunk(self.model_size, model_dim)[self.model_rank]
        if data_dim is not None:
            t = t.chunk(self.data_size, data_dim)[self.data_rank]
        return t.contiguous() if t is not full else t

    def unshard(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's shard (a collective: every rank
        calls it, leaf by leaf in the same order)."""
        model_dim, data_dim, _ = self._dims(name)
        t = local
        if data_dim is not None:
            t = all_gather_dim(t, data_dim, self.data_group, self.data_size)
        if model_dim is not None:
            t = all_gather_dim(t, model_dim, self.model_group, self.model_size)
        return t.contiguous()

    def is_whole(self, name: str) -> bool:
        return all(a is None for a in self.specs[name])

    @torch.no_grad()
    def gather_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Fill the modules' parameters from the stored shards before a
        forward: all-gathered over the data axis, and over the model axis
        where the layer does not run column-parallel."""
        for name, w in zip(self.names, self.working):
            if self.is_whole(name):
                continue
            model_dim, data_dim, colpar = self._dims(name)
            t = params[name]
            if data_dim is not None:
                t = all_gather_dim(t, data_dim, self.data_group, self.data_size)
            if model_dim is not None and not colpar:
                t = all_gather_dim(t, model_dim, self.model_group, self.model_size)
            w.copy_(t)

    @torch.no_grad()
    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The modules' gradients (in ``names`` order) → the stored shards'
        gradients, averaged over the data axis: reduce-scattered where the
        leaf splits over data, all-reduced in flat buckets where it does not
        (on one data rank too: the identity there). A gradient over the model
        axis needs no reduction: the model ranks compute the whole network
        alike, and a rank keeps its slice."""
        out, whole = [], []
        for name, g in zip(self.names, grads):
            model_dim, data_dim, colpar = self._dims(name)
            if model_dim is not None and not colpar:
                g = g.chunk(self.model_size, model_dim)[self.model_rank]
            if data_dim is not None:
                g = _reduce_scatter(g, data_dim, self.data_group, self.data_size).contiguous()
            else:
                whole.append(len(out))
            out.append(g)
        all_reduce_flat([out[i] for i in whole], self.data_group)
        if self.data_size > 1:
            torch._foreach_div_(out, float(self.data_size))
        return out

    @torch.no_grad()
    def reduce_mean(self, value: torch.Tensor) -> torch.Tensor:
        """The mean of a per-rank value over the data axis."""
        value = value.clone()
        dist.all_reduce(value, group=self.data_group)
        return value / self.data_size if self.data_size > 1 else value

    @torch.no_grad()
    def grad_norm(self, grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
        """The global norm of the stored shards' gradients: each leaf's
        squared norm summed over the ranks that split it. None when nothing
        is split (the optimizer then takes the norm as the one-rank step
        does)."""
        if not self.sharded:
            return None
        sq = torch.stack(torch._foreach_norm(grads)).square()
        for axis_name, group, size in ((DATA_AXIS, self.data_group, self.data_size),
                                       (MODEL_AXIS, self.model_group, self.model_size)):
            idx = [i for i, n in enumerate(self.names) if axis_name in self.specs[n]]
            if idx and size > 1:
                part = sq[idx].contiguous()
                dist.all_reduce(part, group=group)
                sq[idx] = part
        return sq.sum().sqrt()

    # ---- whole state ----
    @torch.no_grad()
    def full_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every parameter whole (a collective when anything is split)."""
        if not self.sharded:
            return dict(params)
        return {n: self.unshard(n, params[n]) for n in self.names}

    @torch.no_grad()
    def full_model(self, full_params: Dict[str, torch.Tensor]) -> nn.Module:
        """A copy of the model with whole layers and ``full_params``: what the
        sample grids and the HF export use. The model itself when nothing is
        split (its parameters are the state's)."""
        if not self.sharded:
            return self.model
        twin = copy.deepcopy(self.model)
        for name, (pre, post) in self._hooks.items():
            module = twin.get_submodule(name)
            del module._forward_pre_hooks[pre]
            module._forward_pre_hooks_with_kwargs.pop(pre, None)
            del module._forward_hooks[post]
            for leaf in ("weight", "bias"):
                shard = getattr(module, leaf, None)
                if shard is not None:
                    setattr(module, leaf, nn.Parameter(full_params[f"{name}.{leaf}"].to(shard.device, copy=True)))
        params = dict(twin.named_parameters())
        for name in self.names:
            if name.rpartition(".")[0] not in self._hooks:
                params[name].copy_(full_params[name])
        return twin


def place_train_state(state, layout: Optional[ParallelLayout]):
    """Split a whole ``TrainState`` (parameters, Adam moments) into this
    rank's shards of ``layout``. A leaf that nothing splits stays the
    module's own parameter; with nothing split, the state is returned as it
    is."""
    if layout is None or not layout.sharded:
        return state
    for name in layout.names:
        if tuple(state.params[name].shape) != layout.full_shapes[name]:
            raise ValueError(f"{name}: the state holds {tuple(state.params[name].shape)}, not the whole "
                             f"{layout.full_shapes[name]}; build the state before the layout")

    def split(name, t):
        return t if layout.is_whole(name) else layout.shard(name, t.detach())

    state.params = {n: split(n, state.params[n]) for n in layout.names}
    state.opt_state.mu = [split(n, m) for n, m in zip(layout.names, state.opt_state.mu)]
    state.opt_state.nu = [split(n, v) for n, v in zip(layout.names, state.opt_state.nu)]
    return state
