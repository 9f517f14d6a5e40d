"""The node grids the port plans, derived from the reference's plan by the
exact ``Reduce`` rule: shared by the planner parity tests."""
from repro.core import boundary as rboundary
from repro.core import ir as rir


def exact_node_grids(rp, roots):
    """``{id(node): ((t0, length, prec), below)}`` over the reference DAG of
    ``roots`` as the reference plan ``rp`` grids it.  ``below`` says a
    ``Reduce`` reads the node, directly or through other nodes.

    A node no ``Reduce`` reads keeps the reference's grid.  Any other node
    keeps the reference's precision and right edge and begins at its exact
    demand, rounded down to its precision: a ``Reduce`` whose grid is
    ``(t0, ·, p)`` with window ``W`` reads its argument ``max(-t0 + W - p,
    0)`` back, and every other consumer asks what the reference's rule asks
    of its own demand."""
    order = rir.topo_order_multi(list(roots))
    demand = {id(r): 0 for r in roots}
    below = {id(r): False for r in roots}
    grids = {}
    for n in reversed(order):
        rg = rp.plan_of(n)
        if below[id(n)]:
            t0 = (-demand[id(n)] // n.prec) * n.prec
            right = rg.t0 + rg.length * rg.prec
            grids[id(n)] = (t0, (right - t0) // n.prec, n.prec)
        else:
            grids[id(n)] = (rg.t0, rg.length, rg.prec)
        for a in n.args:
            if isinstance(n, rir.Reduce):
                lb = max(-grids[id(n)][0] + n.window - n.prec, 0)
                bel = True
            else:
                lb = rboundary._edge(
                    n, a, rboundary.Bounds(demand[id(n)], 0)).lookback
                bel = below[id(n)]
            demand[id(a)] = max(demand.get(id(a), 0), lb)
            below[id(a)] = below.get(id(a), False) or bel
    return {k: (grids[k], below[k]) for k in grids}


def assert_node_grids(port_order, ref_order, port_plan, ref_plan, roots):
    """Node for node, in the two packages' topological orders: the grid of
    a node no ``Reduce`` reads is the reference's; that of a node a
    ``Reduce`` reads has the reference's precision and right edge and
    begins at the exact demand (:func:`exact_node_grids`)."""
    assert [type(n).__name__ for n in port_order] == [
        type(n).__name__ for n in ref_order]
    want = exact_node_grids(ref_plan, roots)
    for n, rn in zip(port_order, ref_order):
        g, rg = port_plan.plan_of(n), ref_plan.plan_of(rn)
        (t0, _length, _prec), below = want[id(rn)]
        if not below:
            assert (g.t0, g.length, g.prec) == (rg.t0, rg.length, rg.prec)
        else:
            assert (g.prec, g.t0 + g.length * g.prec) == (
                rg.prec, rg.t0 + rg.length * rg.prec)
            assert g.t0 == t0, (type(n).__name__, g.t0, t0)
