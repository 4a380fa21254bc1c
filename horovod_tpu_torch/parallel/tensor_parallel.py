"""Tensor parallelism (port of ``horovod_tpu/parallel/tensor_parallel.py``).

The JAX package annotates the transformer's weights with
``PartitionSpec``s from a table of path regexes and lets GSPMD insert
the collectives.  The port keeps the table (:func:`transformer_sharding_rules`,
specs as tuples of axis names) and realises each layout with explicit
collectives on the mesh axis' process group, as Megatron-LM does:

- :func:`copy_to` (identity forward, allreduce backward) before each
  column-parallel product: the ``qkv`` projection split over heads, the
  MLP's ``up``, the ``lm_head``;
- :func:`reduce_from` (allreduce forward, identity backward) after each
  row-parallel one: the attention's ``out``, the MLP's ``down``, and the
  vocab-split embedding's masked lookup;
- :func:`gather_from` (all-gather forward, this rank's slice backward):
  the ``lm_head``'s logit shards, gathered so that the loss kernel sees
  whole rows;
- :func:`scatter_to` (this rank's slice forward, all-gather backward):
  :func:`constrain`.

Every rank of a tp group computes the same loss, so these backwards give
a replicated parameter the same gradient on every rank and a shard its
own, neither the group's size times too large nor partial.  Each
collective first lets the eager plane issue what this rank submitted to
it (``Controller.drain``, ROADMAP C.7).
"""

import re
import typing

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.compression import all_gather_into
from horovod_tpu_torch.parallel.mesh import as_mesh


class NamedSharding(typing.NamedTuple):
    """A spec (a tuple of axis names or None, one per dimension) on a
    mesh: what ``jax.sharding.NamedSharding`` is to the JAX package."""

    mesh: object
    spec: tuple


def transformer_sharding_rules(tp_axis="tp", fsdp_axis=None):
    """[(path_regex, spec)] for GPT-style parameter names.

    Matching is ``re.search`` over the ``/``-joined parameter path, first
    match wins.  ``fsdp_axis`` also splits the non-tp dimension of the
    big matrices when given.
    """
    f = fsdp_axis
    return [
        # attention; the fused qkv kernel is [d, 3, heads, d_head] —
        # split the heads dim
        (r"attn.*qkv.*kernel", (f, None, tp_axis, None)),
        (r"attn.*(query|key|value).*kernel", (f, tp_axis)),
        (r"attn.*(out|proj_out|output).*kernel", (tp_axis, f)),
        # mlp
        (r"mlp.*(up|fc1|wi|gate).*kernel", (f, tp_axis)),
        (r"mlp.*(down|fc2|wo).*kernel", (tp_axis, f)),
        # moe experts: [n_experts, d_in, d_out]
        (r"moe.*(wi|up).*kernel", ("ep", f, tp_axis)),
        (r"moe.*(wo|down).*kernel", ("ep", tp_axis, f)),
        (r"moe.*router.*kernel", (f, None)),
        # embeddings / head: vocab-split; position table replicated
        (r"pos_embed", ()),
        (r"(embed|wte).*embedding", (tp_axis, f)),
        (r"(lm_head|output_head).*kernel", (f, tp_axis)),
        # biases & layernorms replicated
        (r".*", ()),
    ]


def _path_str(name):
    """A torch parameter name (``block_0.attn.qkv.kernel``) as the JAX
    package's ``/``-joined path."""
    return name.replace(".", "/")


def spec_for_path(path, rules):
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return ()


def _fit_spec(spec, ndim):
    """Trim/pad a spec to the array rank (drop trailing axes that don't
    exist, e.g. biases matched by a kernel rule)."""
    parts = tuple(spec) + (None,) * max(0, ndim - len(spec))
    return parts[:ndim]


def _named(params):
    """(name, tensor) pairs of a module or a ``{name: tensor}`` dict."""
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict().items())
    return list(params.items())


def params_shardings(params, mesh, rules=None):
    """``{name: NamedSharding}`` of each parameter through the rule
    table, axes the mesh lacks dropped (e.g. no ``ep`` axis).  ``params``:
    a module or a ``{name: tensor or array}`` dict; ``mesh``: a
    :class:`~horovod_tpu_torch.parallel.mesh.Mesh` or ``hvd.grid(...)``."""
    mesh = as_mesh(mesh)
    if rules is None:
        rules = transformer_sharding_rules()
    axes = set(mesh.axis_names)

    def one(name, x):
        spec = spec_for_path(_path_str(name), rules)
        parts = tuple(a if (a is None or a in axes) else None
                      for a in _fit_spec(spec, len(x.shape)))
        return NamedSharding(mesh, parts)

    return {name: one(name, x) for name, x in _named(params)}


def shard_tensor(x, sharding, rank=None):
    """This rank's block of the full tensor ``x`` under ``sharding``: each
    dimension with an axis cut into that axis' size of equal parts, the
    part at this rank's coordinate kept (a copy)."""
    mesh = sharding.mesh
    if rank is None:
        from horovod_tpu_torch.common import basics
        rank = basics.rank()
    coords, shape = mesh.coords(rank), mesh.shape
    for dim, axis in enumerate(sharding.spec):
        if axis is None:
            continue
        n = shape[axis]
        if x.shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of shape {tuple(x.shape)} does not split "
                f"into {n} parts over mesh axis {axis!r}")
        size = x.shape[dim] // n
        x = x.narrow(dim, coords[axis] * size, size)
    return x.clone()


def shard_params(params, mesh, rules=None, rank=None):
    """``{name: this rank's block}`` of full parameters (a module or a
    dict of tensors).  ``mesh`` is a mesh or grid, split through the rule
    table, or the ``{name: NamedSharding}`` of :func:`params_shardings`
    (e.g. from ``MeshExecutor.named_sharding``)."""
    named = _named(params)
    if isinstance(mesh, dict):
        shardings = mesh
    else:
        shardings = params_shardings(dict(named), mesh, rules)
    return {name: shard_tensor(torch.as_tensor(x), shardings[name], rank)
            for name, x in named}


# ------------------------------------------------ collectives on an axis
def _after_eager_plane():
    from horovod_tpu_torch.optimizer import _after_eager_plane as drain
    drain()


def _all_reduce(x, group):
    out = x.contiguous().clone()
    _after_eager_plane()
    with basics.abortable():
        dist.all_reduce(out, group=group)
    return out


def _all_gather(x, group, dim):
    """The group's tensors concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    src = x.contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _after_eager_plane()
    with basics.abortable():
        all_gather_into(out, src, group=group)
    return torch.cat(out.chunk(n), dim=dim)


def _own_slice(x, group, dim):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, *ctx.args), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _own_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None


def _trivial(group):
    return group is None or dist.get_world_size(group) == 1


def copy_to(x, group):
    """Identity forward, allreduce of the gradient over ``group`` (a
    ``torch.distributed`` group; None: no-op) backward."""
    return x if _trivial(group) else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Allreduce (sum) over ``group`` forward, identity backward."""
    return x if _trivial(group) else _ReduceFrom.apply(x, group)


def gather_from(x, group, dim):
    """All-gather along ``dim`` forward, this rank's slice backward."""
    return x if _trivial(group) else _GatherFrom.apply(x, group, dim)


def scatter_to(x, group, dim):
    """This rank's slice along ``dim`` forward, all-gather backward."""
    return x if _trivial(group) else _ScatterTo.apply(x, group, dim)


def axis_torch_group(mesh, axis):
    """The ``torch.distributed`` group of this rank along ``axis``, or
    None where the mesh is None or lacks the axis."""
    if mesh is None:
        return None
    mesh = as_mesh(mesh)
    if axis not in mesh.axis_names:
        return None
    from horovod_tpu_torch import groups
    return groups.torch_group(mesh.group(axis))


def constrain(x, mesh, *spec):
    """Activation layout: a replicated ``x`` cut to this rank's block
    along each dimension whose spec names a mesh axis (the gradient is
    all-gathered back); a true no-op where the mesh lacks every named
    axis."""
    mesh = as_mesh(mesh)
    for dim, axis in enumerate(spec):
        if axis is not None and axis in mesh.axis_names:
            x = scatter_to(x, axis_torch_group(mesh, axis), dim)
    return x
