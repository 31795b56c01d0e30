"""Per-op cost attribution of a counted step (the port's counterpart of
``repro.launch.attribution``): the top ops by bytes and by flops, so that a
dry-run cell's dominant roofline term can be blamed on named ops.

``python -m repro_torch.launch.dryrun ... --attribute N`` stores
``attribute(cost, top=N)`` in the cell's record as "top_bytes" and
"top_flops".
"""
from __future__ import annotations

from repro_torch.launch.op_cost import OpCost

__all__ = ["attribute"]


def attribute(cost_trace: OpCost, top: int = 20):
    """Rank the ops of a traced :class:`OpCost` (``op_cost.counting(trace=
    True)``) by bytes and by flops.  Ops with the same place (a parameter's
    module path and the port's function that ran it, or the function
    alone), aten op (or ``kernel.<name>``) and result shape are one entry,
    ``xN`` the calls summed in it, as the reference's ``x<trips>``.  Returns
    ``(top_bytes, top_flops)``: lists of {"gib" | "gflop", "inst"}."""
    groups: dict = {}
    for place, op, nbytes, flops, shape in cost_trace.records:
        key = (place, op, shape)
        n, b, f = groups.get(key, (0, 0.0, 0.0))
        groups[key] = (n + 1, b + nbytes, f + flops)

    def inst(key, n):
        place, op, shape = key
        return f"{place} {op} x{n} {list(shape)}"

    by_bytes = sorted(groups.items(), key=lambda kv: -kv[1][1])
    by_flops = sorted((kv for kv in groups.items() if kv[1][2] > 0), key=lambda kv: -kv[1][2])
    return (
        [{"gib": round(b / 2**30, 3), "inst": inst(k, n)} for k, (n, b, _) in by_bytes[:top]],
        [{"gflop": round(f / 1e9, 1), "inst": inst(k, n)} for k, (n, _, f) in by_flops[:top]],
    )
