"""Expert parallelism: switch (top-1) Mixture-of-Experts (port of
``horovod_tpu/parallel/moe.py``).

The routing is the JAX package's: softmax router in fp32, argmax expert,
capacity ``C = ceil(capacity_factor * S / E)`` per group of ``S`` tokens,
queue positions in token order, overflow and padding passed through with
combine weight 0, and Switch Transformer's balancing loss ``E * sum(f *
p)`` from the routing before the capacity drop.

It routes with indices where the reference multiplies ``[G, S, E, C]``
one-hot tensors (``einsum("gsd,gsec->gecd")`` and back): each of those
sums has one non-zero term, so a gather into the ``[G, E, C, D]`` slots
and a gather back out give the same values, without the one-hots (at
4 x 4096 x 8 x 640 fp32 they would take 335 MB a layer).  The expert
FFN runs in fp32 with the tanh GELU, as in the reference.

Under a mesh with an ``ep`` axis the expert weights hold this rank's
``E / ep`` experts (the ``moe.*`` rules of ``tensor_parallel.py``), and
so does the expert dimension of the slots.  Tokens are replicated over
``ep`` (split over ``dp``), so every ep rank routes the same tokens,
fills and runs only its own experts' slots, and all-gathers the experts'
outputs over ``ep`` before combining them with the gates.  The ranks of
an ep group compute the same loss, so the collectives' backwards set the
scale of the gradients:

- the router and everything before it are replicated: the combine runs
  on the gathered outputs with the whole gates on every rank, so the
  router's gradient is whole there (combined on a rank's own experts it
  would see only their tokens);
- the tokens fed into this rank's slots pass :func:`copy_to`, whose
  backward sums the experts' contributions to the input's gradient over
  ``ep`` (the router's contribution stays out of that sum, else it would
  come out ``ep`` times too large);
- the all-gather's backward keeps this rank's slice of the (replicated)
  gradient of the outputs: each expert gets its own gradient.

Under a ``tp`` axis too, each expert's hidden dimension is split
(``wi`` by columns, ``wo`` by rows) with :func:`copy_to` before and
:func:`reduce_from` after, as the dense MLP.
"""

import math
import typing

import torch
import torch.nn.functional as F

from horovod_tpu_torch.parallel.tensor_parallel import (axis_torch_group,
                                                        copy_to, gather_from,
                                                        reduce_from)


class Route(typing.NamedTuple):
    """Top-1 routing of ``[..., T]`` tokens (leading dims: groups)."""

    expert: torch.Tensor   # argmax expert, int64
    pos: torch.Tensor      # queue position within that expert, int64
    kept: torch.Tensor     # routed and within capacity (bool)
    gate: torch.Tensor     # the chosen expert's probability, fp32
    aux: torch.Tensor      # balancing loss (per group for batched input)
    routed: torch.Tensor   # [..., E] tokens routed to each expert, pre-drop
    capacity: int

    def dispatch(self):
        """The reference's ``[..., T, E, C]`` dispatch one-hot."""
        e = self.routed.shape[-1]
        return (F.one_hot(self.expert, e).float()[..., None]
                * F.one_hot(self.pos.clamp(max=self.capacity - 1),
                            self.capacity).float()[..., None, :]
                * self.kept[..., None, None])

    def combine(self):
        """The reference's ``[..., T, E, C]`` combine weights."""
        return self.dispatch() * self.gate[..., None, None]


def switch_route(router_logits, n_experts, capacity, valid=None):
    """Top-1 routing from ``[..., T, E]`` logits.  ``valid`` (``[..., T]``)
    excludes padding tokens: they take no queue positions and no
    capacity, and do not enter the balancing loss."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate, expert = probs.max(dim=-1)
    routed_1h = F.one_hot(expert, n_experts).float()
    if valid is not None:
        routed_1h = routed_1h * valid[..., None].float()
    # position of each token within its expert's queue
    pos_in_expert = (torch.cumsum(routed_1h, dim=-2) - 1.0) * routed_1h
    kept_1h = routed_1h * (pos_in_expert < capacity)
    pos = (pos_in_expert * kept_1h).sum(-1).long()
    kept = kept_1h.sum(-1) > 0
    # Switch Transformer's balancing loss, with f from the routing before
    # the capacity drop
    if valid is not None:
        v = valid.float()
        denom = v.sum(-1, keepdim=True).clamp(min=1.0)
        f = routed_1h.sum(-2) / denom
        p = (probs * v[..., None]).sum(-2) / denom
    else:
        f = routed_1h.mean(-2)
        p = probs.mean(-2)
    aux = n_experts * (f * p).sum(-1)
    return Route(expert, pos, kept, gate, aux, routed_1h.sum(-2), capacity)


def switch_moe(x, params, *, capacity_factor=1.25, group_size=4096,
               mesh=None, stats=None):
    """Apply a switch-MoE FFN to ``x [..., T, D]`` (leading dims folded).

    ``params``: ``{"router": {"kernel": [D, E]}, "wi": {"kernel": [E', D,
    F']}, "wo": {"kernel": [E', F', D]}}`` (:func:`init_moe_params`); under
    a mesh with ``ep`` (``tp``), ``E'`` (``F'``) is this rank's share.
    Tokens are routed in groups of ``group_size`` (the last one padded).
    ``stats``: a dict to fill with the routing's counts (``routed``,
    ``kept`` a expert; ``dropped``, ``valid`` tokens).  -> (output in
    ``x``'s dtype, the balancing loss averaged over groups)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    router = params["router"]["kernel"]
    wi, wo = params["wi"]["kernel"], params["wo"]["kernel"]
    e = router.shape[1]
    ep = axis_torch_group(mesh, "ep")
    tp = axis_torch_group(mesh, "tp")
    e_local = wi.shape[0]
    n_ep = e // e_local
    if n_ep * e_local != e:
        raise ValueError(f"{e} experts do not split into groups of "
                         f"{e_local}")
    e0 = (torch.distributed.get_rank(ep) if ep is not None else 0) * e_local

    s = min(group_size, t)
    pad = (-t) % s
    if pad:
        xt = torch.cat([xt, xt.new_zeros(pad, d)])
    g = (t + pad) // s
    xg = xt.reshape(g, s, d)
    capacity = int(math.ceil(capacity_factor * s / e))

    logits = torch.matmul(xg.float(), router.float())       # [G, S, E]
    valid = (torch.arange(g * s, device=x.device) < t).reshape(g, s)
    route = switch_route(logits, e, capacity, valid=valid)
    if stats is not None:
        stats.update(routed=route.routed.sum(0).long().detach(),
                     kept=(F.one_hot(route.expert, e)
                           * route.kept[..., None]).sum((0, 1)).detach(),
                     valid=t,
                     dropped=(valid & ~route.kept).sum().detach())

    # this rank's experts' slots, [G, E' * C, D]
    mine = route.kept & (route.expert >= e0) & (route.expert < e0 + e_local)
    gi, si = mine.nonzero(as_tuple=True)
    slot = (route.expert[gi, si] - e0) * capacity + route.pos[gi, si]
    x_exp = copy_to(copy_to(xg, tp), ep)
    expert_in = xg.new_zeros((g, e_local * capacity, d), dtype=torch.float32)
    expert_in = expert_in.index_put((gi, slot), x_exp[gi, si].float())

    h = expert_in.view(g, e_local, capacity, d).transpose(0, 1).reshape(
        e_local, g * capacity, d)
    h = F.gelu(torch.bmm(h, wi.float()), approximate="tanh")
    y = reduce_from(torch.bmm(h, wo.float()), tp)            # [E', G*C, D]
    expert_out = y.view(e_local, g, capacity, d).transpose(0, 1)
    expert_out = gather_from(expert_out, ep, dim=1)          # [G, E, C, D]

    slot_all = route.expert * capacity + route.pos.clamp(max=capacity - 1)
    picked = torch.gather(expert_out.reshape(g, e * capacity, d), 1,
                          slot_all[..., None].expand(g, s, d))
    out = picked * (route.gate * route.kept)[..., None]
    out = out.reshape(-1, d)[:t]
    return out.to(x.dtype).reshape(orig_shape), route.aux.mean()


def moe_param_shapes(d_model, d_ff, n_experts):
    """The switch_moe parameter contract, shared by :func:`init_moe_params`
    and the transformer's ``MoeMlp``."""
    return {
        "router": (d_model, n_experts),
        "wi": (n_experts, d_model, d_ff),
        "wo": (n_experts, d_ff, d_model),
    }


def moe_kernel_init(generator, shape, dtype=torch.float32):
    """Normal(0, 1/fan_in), fan_in the contracted (second-to-last)
    dimension; drawn from a ``torch.Generator`` on the CPU."""
    scale = 1.0 / math.sqrt(shape[-2])
    return (torch.randn(*shape, generator=generator) * scale).to(dtype)


def init_moe_params(generator, d_model, d_ff, n_experts,
                    dtype=torch.float32):
    """Full-size parameters of :func:`switch_moe`, drawn in the order of
    :func:`moe_param_shapes`."""
    shapes = moe_param_shapes(d_model, d_ff, n_experts)
    return {name: {"kernel": moe_kernel_init(generator, shape, dtype)}
            for name, shape in shapes.items()}
