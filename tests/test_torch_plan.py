"""Port parity of ``core/plan.py``'s plan API on the reference's toy network
(``tests/test_graph_fusion.py``'s ``_toy_net``): ``GroupPlan.fused``,
``members``, ``cache_key`` and ``describe()``, ``LayerPlan.describe()`` and
``ExecutionPlan.modes`` against ``repro.core.plan``, with the kernels'
impl name mapped (``pallas_mapmajor`` -> ``cuda_mapmajor``)."""
from dataclasses import replace

import pytest

import repro.core as J
from repro.core.network import NetworkDescription as JaxNetworkDescription
from repro.core.parallelism import Parallelism as JaxParallelism
from repro.core.plan import GroupPlan as JaxGroupPlan
from repro.core.plan import LayerPlan as JaxLayerPlan
from repro_torch.core import (ComputeMode, ExecutionPlan, LayerPlan, Parallelism,
                              lower_network, plan_network)
from repro_torch.core.network import NetworkDescription
from repro_torch.core.plan import GroupPlan

from _torch_parity import jax_mode
from test_torch_synthesis import IMPL_NAMES

#: The port's fingerprints of the planned toy network, as before the plan
#: API was completed: adding names must not change a plan's identity.
FINGERPRINTS = {"planner": "6a1fee6326485c48", "relaxed": "d3f0f0bdc6253006",
                "uniform-mapmajor": "087affcfed802c0d"}


def _toy_net(cls):
    net = cls("toy", (3, 12, 12))
    net.conv("c1", 8, 3, padding="SAME", inputs=("input",))
    net.relu("r1")
    net.lrn("n1")
    net.maxpool("p1", 2, 2)
    net.conv("c2", 8, 3, padding="SAME")
    net.relu("r2")
    net.gap("g")
    net.dense("d", 4)
    net.softmax("prob")
    return net


def _plans(case):
    """(reference plan, port plan, reference graph, port graph) of ``case``."""
    jnet, net = _toy_net(JaxNetworkDescription), _toy_net(NetworkDescription)
    jgraph, graph = J.lower_network(jnet), lower_network(net)
    if case == "uniform-mapmajor":
        modes = {n: ComputeMode.IMPRECISE for n in net.inexactable_layers}
        jplan = J.ExecutionPlan.uniform(
            jnet, backend="pallas", parallelism=JaxParallelism.OLP,
            modes={n: jax_mode(m) for n, m in modes.items()}).with_graph(jgraph)
        plan = ExecutionPlan.uniform(net, backend="mapmajor", parallelism=Parallelism.OLP,
                                     modes=modes).with_graph(graph)
        return jplan, plan, jgraph, graph
    modes = ({n: ComputeMode.RELAXED for n in net.inexactable_layers}
             if case == "relaxed" else None)
    jplan = J.plan_network(jnet, graph=jgraph,
                           modes=modes and {n: jax_mode(m) for n, m in modes.items()})
    plan = plan_network(net, graph=graph, modes=modes)
    return jplan, plan, jgraph, graph


def _mapped(jlp):
    """The reference's layer plan as the port's, field for field."""
    return LayerPlan(impl=IMPL_NAMES[jlp.impl], parallelism=Parallelism(jlp.parallelism.value),
                     mode=ComputeMode(jlp.mode.value), u=jlp.u, reason=jlp.reason,
                     vmem_budget=jlp.vmem_budget)


def _head(text: str) -> str:
    """A ``describe()`` line without its reason (the cost rules' notes
    name each package's own numeric path)."""
    return text.split("  [")[0]


@pytest.mark.parametrize("case", sorted(FINGERPRINTS))
def test_group_and_layer_plans_describe_and_key_as_the_reference(case):
    jplan, plan, jgraph, graph = _plans(case)
    fingerprint = plan.fingerprint()
    assert [g.name for g in graph.groups] == [g.name for g in jgraph.groups]
    n_fused = 0
    for jg, g in zip(jgraph.groups, graph.groups):
        jgp, gp = jplan.for_group(jg), plan.for_group(g)
        assert isinstance(gp, GroupPlan)
        assert gp.members == jgp.members
        assert gp.fused is jgp.fused
        n_fused += gp.fused
        assert gp.cache_key == (gp.members, gp.plan.cache_key)
        assert gp.plan.impl == IMPL_NAMES[jgp.plan.impl]
        assert _head(gp.describe()) == _head(jgp.describe()).replace(
            jgp.plan.impl, gp.plan.impl)
        # The same fields give the same text, reason included.
        same = GroupPlan(gp.name, gp.members, _mapped(jgp.plan))
        assert same.describe() == jgp.describe().replace(jgp.plan.impl, gp.plan.impl)
        # A fused group's key differs from its anchor's solo one; a solo
        # group's equals it, and plans that differ only in their reason
        # give equal keys.
        solo = GroupPlan(gp.name, gp.members[:1], gp.plan)
        jsolo = JaxGroupPlan(jgp.name, jgp.members[:1], jgp.plan)
        assert (gp.cache_key != solo.cache_key) is gp.fused \
            is (jgp.cache_key != jsolo.cache_key)
        assert gp.cache_key == GroupPlan(gp.name, gp.members,
                                         replace(gp.plan, reason="other")).cache_key
        assert jgp.cache_key == JaxGroupPlan(jgp.name, jgp.members,
                                             replace(jgp.plan, reason="other")).cache_key
    assert n_fused == 2
    for name, jlp in jplan:
        lp = plan.for_layer(name)
        assert _head(lp.describe()) == _head(jlp.describe()).replace(jlp.impl, lp.impl)
        assert _mapped(jlp).describe() == jlp.describe().replace(jlp.impl, lp.impl)
    assert {n: m.value for n, m in plan.modes.items()} == \
        {n: m.value for n, m in jplan.modes.items()}
    assert list(plan.modes) == list(jplan.modes)
    assert plan.fingerprint() == fingerprint == FINGERPRINTS[case]


def test_layer_plan_describe_without_a_reason_has_no_brackets():
    assert LayerPlan().describe() == JaxLayerPlan().describe() == "default olp precise u=128"
