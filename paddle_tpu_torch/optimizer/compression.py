"""Gradient compression and local SGD
(``paddle_tpu/optimizer/compression.py``): ``DGC``, a gradient transform
with momentum correction, error feedback and top-k sparsification; and
``LocalSGD`` / ``localsgd_average``, workers that step on their own and
average their parameters over the mesh's "dp" axis every ``k_steps``
(one all-reduce per parameter, in place).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence

import torch


def _quantile(flat: torch.Tensor, q) -> torch.Tensor:
    """``jnp.quantile(flat, q)`` with its linear interpolation, in the same
    operations: sort, ``q * (n - 1)`` in float32, the two neighbours
    weighted by the fraction."""
    n = flat.numel()
    a = torch.sort(flat).values
    q = torch.as_tensor(q, dtype=torch.float32, device=flat.device) * \
        float(n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_weight = q - low
    low_weight = 1 - high_weight
    low = torch.clamp(low, 0, n - 1).long()
    high = torch.clamp(high, 0, n - 1).long()
    return (a[low].float() * low_weight
            + a[high].float() * high_weight).to(flat.dtype)


class DGC:
    """Deep-gradient-compression transform with momentum correction.

    State per gradient: ``u`` (momentum) and ``v`` (error accumulation).
    Per step: ``u = m*u + g; v = v + u; mask = |v| > quantile(|v|,
    sparsity); out = v*mask; v = v*(1-mask); u = u*(1-mask)``.
    ``rampup_steps > 0`` ramps the sparsity from 0.75 to its target over
    that many steps. Gradients and state are lists in one order."""

    def __init__(self, momentum: float = 0.9, sparsity: float = 0.9,
                 rampup_steps: int = 0):
        self.momentum = momentum
        self.sparsity = sparsity
        self.rampup_steps = rampup_steps

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, object]:
        return {"u": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params],
                "step": torch.zeros((), dtype=torch.int32,
                                    device=params[0].device)}

    def _sparsity_at(self, step: torch.Tensor):
        if self.rampup_steps <= 0:
            return self.sparsity
        frac = torch.clamp(step.to(torch.float32) / self.rampup_steps,
                           max=1.0)
        return 0.75 + (self.sparsity - 0.75) * frac

    def transform(self, grads: Sequence[torch.Tensor], state):
        """-> (sparsified gradients, new state)."""
        sp = self._sparsity_at(state["step"])
        outs: List[torch.Tensor] = []
        new_u: List[torch.Tensor] = []
        new_v: List[torch.Tensor] = []
        for g, u, v in zip(grads, state["u"], state["v"]):
            u2 = self.momentum * u + g
            v2 = v + u2
            if v2.numel() <= 1:
                outs.append(v2)
                new_u.append(torch.zeros_like(u2))
                new_v.append(torch.zeros_like(v2))
                continue
            thr = _quantile(torch.abs(v2).reshape(-1), sp)
            mask = (torch.abs(v2) > thr).to(g.dtype)
            outs.append(v2 * mask)
            new_u.append(u2 * (1 - mask))
            new_v.append(v2 * (1 - mask))
        return outs, {"u": new_u, "v": new_v, "step": state["step"] + 1}


def localsgd_average(params: Iterable[torch.Tensor], axis="dp", mesh=None):
    """Average every parameter over the mesh's ``axis`` (a LocalSGD sync
    point), in place on each rank: the mean of the members' values (the
    reference's ``pmean``). ``mesh`` defaults to the ambient
    ``mesh_context``."""
    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.parallel import collective
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    if mesh is None:
        raise ValueError("localsgd_average needs a mesh: pass mesh= or "
                         "enter mesh_context()")
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = math.prod(mesh_lib.axis_size(mesh, a) for a in axes)
    with torch.no_grad():
        for p in params:
            p.copy_(collective.all_reduce(p, axes, mesh=mesh) / n)


class LocalSGD:
    """Periodic averaging: :meth:`maybe_average` averages the parameters
    over ``axis`` at every step with ``step % k_steps == 0`` (step 0
    included, as the reference's schedule does) and leaves them
    otherwise; returns whether it averaged."""

    def __init__(self, k_steps: int = 4, axis: str = "dp"):
        self.k_steps = k_steps
        self.axis = axis

    def maybe_average(self, params, step, mesh=None) -> bool:
        if int(step) % self.k_steps:
            return False
        localsgd_average(params, self.axis, mesh)
        return True
