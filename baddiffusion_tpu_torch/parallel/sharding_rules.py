"""Which dimension of each parameter splits over which mesh axis (port of
``baddiffusion_tpu/parallel/sharding_rules.py``).

A spec is a tuple with one entry per dimension of the port's parameter:
``None`` (whole on every rank) or the mesh axis that dimension splits over.
The rules are the JAX package's, applied to the port's parameters as the
flax tree holds them, so the two packages split the same leaves:

  - tensor parallelism (``unet_param_specs``, threshold 256): a conv or
    dense kernel whose output channels O ≥ threshold splits O over ``model``;
    a 1-D bias or GroupNorm scale of at least threshold elements splits over
    ``model``;
  - FSDP (``fsdp_param_specs``): every leaf of at least ``min_size``
    elements also splits its largest dimension not yet split that the data
    size divides, over ``data``; ties go to the earlier dimension in flax's
    order.

Flax holds a conv kernel as HWIO and a dense kernel as [I, O]; the port holds
OIHW and [O, I] (``io.hf``'s mapping), and the GroupNorm ``scale`` as
``weight``. ``flax_view`` gives each parameter's flax name, its flax shape
and the port's dimension for each flax dimension; the rules run on the flax
shape (which fixes the tie order) and the result maps back to the port's
dimensions. ``parallel.layout.ParallelLayout`` turns the specs into shards,
gathers and reductions.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from torch import nn

from baddiffusion_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

Spec = Tuple[Optional[str], ...]
CONV_ORDER = (2, 3, 1, 0)  # the port's (OIHW) dimension of each flax (HWIO) dimension
DENSE_ORDER = (1, 0)  # the port's ([O, I]) dimension of each flax ([I, O]) dimension


def flax_view(model: nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...], Tuple[int, ...]]]:
    """``name -> (flax leaf name, flax shape, port dimension of each flax
    dimension)`` for every trainable parameter of ``model``."""
    out = {}
    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            if not p.requires_grad:
                continue
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            order = tuple(range(p.dim()))
            flax_name = leaf
            if leaf == "weight" and isinstance(module, nn.Conv2d):
                flax_name, order = "kernel", CONV_ORDER
            elif leaf == "weight" and isinstance(module, nn.Linear):
                flax_name, order = "kernel", DENSE_ORDER
            elif leaf == "weight" and isinstance(module, nn.Embedding):
                flax_name = "embedding"
            elif leaf == "weight" and p.dim() == 1:
                flax_name = "scale"
            out[name] = (flax_name, tuple(p.shape[d] for d in order), order)
    return out


def _tp_flax_spec(flax_name: str, shape: Tuple[int, ...], threshold: int) -> Spec:
    nd = len(shape)
    if flax_name == "kernel" and nd in (2, 4) and shape[-1] >= threshold:
        return (None,) * (nd - 1) + (MODEL_AXIS,)
    if nd == 1 and shape[0] >= threshold and flax_name in ("bias", "scale"):
        return (MODEL_AXIS,)
    return (None,) * nd


def _add_fsdp_axis(shape: Tuple[int, ...], spec: Spec, data_size: int, min_size: int, axis: str) -> Spec:
    """Split the largest dimension of ``shape`` not yet split that
    ``data_size`` divides (flax order, stable among equals) over ``axis``;
    a leaf under ``min_size`` elements stays as it is."""
    if math.prod(shape) < min_size:
        return spec
    for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
        if spec[d] is None and shape[d] % data_size == 0:
            return tuple(axis if i == d else spec[i] for i in range(len(shape)))
    return spec


def _to_port(spec: Spec, order: Tuple[int, ...]) -> Spec:
    out = [None] * len(order)
    for flax_dim, port_dim in enumerate(order):
        out[port_dim] = spec[flax_dim]
    return tuple(out)


def unet_param_specs(model: nn.Module, threshold: int = 256) -> Dict[str, Spec]:
    """Tensor-parallel specs over ``model``: wide kernels split their output
    channels, wide biases and GroupNorm scales split, over ``model``."""
    return {name: _to_port(_tp_flax_spec(fname, shape, threshold), order)
            for name, (fname, shape, order) in flax_view(model).items()}


def fsdp_param_specs(model: nn.Module, axis_size: int, min_size: int = 2**16, axis: str = DATA_AXIS
                     ) -> Dict[str, Spec]:
    """ZeRO-3 specs: each leaf of at least ``min_size`` elements splits its
    largest dimension that ``axis_size`` divides over ``axis``."""
    return {name: _to_port(_add_fsdp_axis(shape, (None,) * len(shape), axis_size, min_size, axis), order)
            for name, (_, shape, order) in flax_view(model).items()}


def train_state_specs(
    model: nn.Module,
    data_size: int,
    model_size: int = 1,
    param_sharding: str = "replicated",
    tp_threshold: int = 256,
    fsdp_min_size: int = 2**16,
) -> Dict[str, object]:
    """The specs of a ``TrainState`` on a ``(data, model)`` mesh: tensor
    parallelism when the model axis is above 1, FSDP over the data axis on
    top with ``param_sharding == "fsdp"``. Adam's moments take their
    parameter's spec; the count and the step are whole on every rank."""
    if param_sharding not in ("replicated", "fsdp"):
        raise ValueError(f"param_sharding {param_sharding!r}")
    view = flax_view(model)
    specs = {}
    for name, (fname, shape, order) in view.items():
        spec = _tp_flax_spec(fname, shape, tp_threshold) if model_size > 1 else (None,) * len(shape)
        if param_sharding == "fsdp":
            spec = _add_fsdp_axis(shape, spec, data_size, fsdp_min_size, DATA_AXIS)
        specs[name] = _to_port(spec, order)
    return {"params": specs, "mu": dict(specs), "nu": dict(specs), "count": (), "step": ()}
