"""The flattened P-partition view and its halo exchange against the JAX
package's ring exchange under ``shard_map``.

The port runs the P partitions of a slab graph on one device as ONE graph
(``distmlip_tpu_torch.parallel.halo``): the halo exchange is an
``index_select`` of the owners' rows and an ``index_copy`` into the halo
rows. Here, on the same host graph (the stacked arrays are equal to the
JAX package's, ``tests/test_torch_partition.py``), it must deliver the
same rows as ``LocalGraph.halo_exchange`` on the 8-virtual-device CPU mesh
(``tests/test_halo.py``), send the same gradients back to the owners, do
the same for bond rows and for several arrays at one sync point, and the
split edge sums must equal the JAX package's per-partition sums. Copies are
exact, so equality is exact; sums agree to float32 roundoff (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from distmlip_tpu.neighbors import neighbor_list_numpy as jax_nl
from distmlip_tpu.parallel import GRAPH_AXIS, graph_in_specs, graph_mesh
from distmlip_tpu.parallel.halo import local_graph_from_stacked as jax_local_graph
from distmlip_tpu.parallel.runtime import _NO_CHECK, shard_map
from distmlip_tpu.partition import CapacityPolicy as JCaps
from distmlip_tpu.partition import build_partitioned_graph as jax_build_graph
from distmlip_tpu.partition import build_plan as jax_build_plan
from distmlip_tpu_torch.kernels import CHGNET_ATOM_CONV, TENSORNET_INTERACTION
from distmlip_tpu_torch.kernels.edge_aggregate import (chgnet_atom_message,
                                                       tensornet_interaction_message)
from distmlip_tpu_torch.models import CHGNet, CHGNetConfig
from distmlip_tpu_torch.neighbors import neighbor_list_numpy as port_nl
from distmlip_tpu_torch.ops.nn import gated_mlp_weights
from distmlip_tpu_torch.ops.segment import masked_segment_sum
from distmlip_tpu_torch.parallel import halo, local_graph_from_stacked
from distmlip_tpu_torch.partition import (CapacityPolicy, build_partitioned_graph,
                                          build_plan)
from tests.torch_threads import one_intra_op_thread  # noqa: F401

R, BOND_R = 3.0, 2.0


def _graphs(P, bond=False):
    rng = np.random.default_rng(10 + P)
    lat = np.diag([8.0, 7.5, 7.0 * P])
    n = int(0.04 * abs(np.linalg.det(lat)))
    cart = rng.random((n, 3)) @ lat
    spec = rng.integers(0, 3, n).astype(np.int32)
    a, b = jax_nl(cart, lat, [1, 1, 1], R, bond_r=BOND_R), port_nl(cart, lat, [1, 1, 1], R,
                                                                   bond_r=BOND_R)
    jp = jax_build_plan(a, lat, [1, 1, 1], P, R, BOND_R, bond, impl="numpy")
    jg, jh = jax_build_graph(jp, a, spec, lat, caps=JCaps())
    tp = build_plan(b, lat, [1, 1, 1], P, R, BOND_R, bond)
    tg, th = build_partitioned_graph(tp, b, spec, lat, caps=CapacityPolicy())
    return jg, jh, tp, tg.to("cpu"), th


def _jax_sharded(jg, fn, arr, out_spec=JP(GRAPH_AXIS)):
    mesh = graph_mesh(jg.num_partitions)

    def f(graph_l, x):
        lg, _ = jax_local_graph(graph_l, GRAPH_AXIS)
        return fn(lg, x[0])

    return shard_map(f, mesh=mesh, in_specs=(graph_in_specs(jg), JP(GRAPH_AXIS)),
                     out_specs=out_spec, **_NO_CHECK)(jg, arr)


def _flat(x):
    return torch.from_numpy(np.ascontiguousarray(x)).reshape((-1,) + x.shape[2:])


@pytest.mark.parametrize("P", [2, 3, 4])
def test_halo_exchange_delivers_owner_rows_like_jax(P):
    jg, jh, plan, tg, th = _graphs(P)
    n = len(plan.node_part)
    feats = np.arange(n, dtype=np.float32)[:, None] * 10.0 + np.arange(4, dtype=np.float32)
    local = th.scatter_global(feats, tg.n_cap)
    for p in range(P):  # the exchange must repopulate the halo rows
        local[p, th.owned_counts[p]:] = 0.0
    want = np.asarray(_jax_sharded(jg, lambda lg, x: lg.halo_exchange(x)[None],
                                   jnp.asarray(local)))
    lg = local_graph_from_stacked(tg)
    assert lg.n_cap == P * tg.n_cap and lg.e_split == P * tg.e_split < lg.e_cap
    # only the fields the flattened graph reads were uploaded
    assert isinstance(tg.edge_src, np.ndarray) and isinstance(tg.halo_send_idx, np.ndarray)
    assert all(isinstance(x, torch.Tensor) for x in (tg.positions, tg.species,
                                                      tg.owned_mask, tg.lattice))
    got = lg.halo_exchange(_flat(local)).reshape(local.shape).numpy()
    np.testing.assert_array_equal(got, want)
    for p in range(P):
        g = plan.global_ids[p]
        np.testing.assert_array_equal(got[p, :len(g)], feats[g])


@pytest.mark.parametrize("P", [2, 4])
def test_halo_gradients_flow_to_owner_like_jax(P):
    """d(sum over halo rows)/d(rows): 1 at each border (to-section) row
    per halo copy it feeds, 0 elsewhere; equal to JAX's transposed
    ppermute."""
    jg, jh, plan, tg, th = _graphs(P)
    x = np.random.default_rng(0).normal(size=(P, tg.n_cap, 2)).astype(np.float32)

    def loss(lg, feats):
        halo_mask = lg.node_mask & ~lg.owned_mask
        return jax.lax.psum(jnp.sum(lg.halo_exchange(feats) * halo_mask[:, None]), GRAPH_AXIS)

    want = np.asarray(jax.grad(lambda a: _jax_sharded(jg, loss, a, JP()))(jnp.asarray(x)))
    lg = local_graph_from_stacked(tg)
    xt = _flat(x).requires_grad_(True)
    halo_rows = (torch.from_numpy(tg.node_mask) & ~tg.owned_mask).reshape(-1, 1).to(xt.dtype)
    (got,) = torch.autograd.grad((lg.halo_exchange(xt) * halo_rows).sum(), xt)
    np.testing.assert_array_equal(got.reshape(x.shape).numpy(), want)
    for p in range(P):
        m = plan.node_markers[p]
        assert (want[p, m[1]:m[1 + P]] >= 1).all() and (want[p, :m[1]] == 0).all()


@pytest.mark.parametrize("P", [2, 4])
def test_bond_exchange_and_exchange_all_like_jax(P):
    """Bond rows keyed by their global edge id reach every halo bond row as
    in JAX; ``exchange_all`` refreshes atom and bond arrays together with
    the same result as one exchange each."""
    jg, jh, plan, tg, th = _graphs(P, bond=True)

    def seed(p):
        arr = np.zeros((tg.b_cap, 3), np.float32)
        b_edge = plan.bond_global_edge[p]
        owned_b = plan.bond_markers[p][1 + P]
        arr[:owned_b] = b_edge[:owned_b, None].astype(np.float32) + np.arange(3)
        return arr

    bonds = np.stack([seed(p) for p in range(P)])
    want = np.asarray(_jax_sharded(jg, lambda lg, x: lg.bond_halo_exchange(x)[None],
                                   jnp.asarray(bonds)))
    lg = local_graph_from_stacked(tg)
    got = lg.bond_halo_exchange(_flat(bonds)).reshape(bonds.shape).numpy()
    np.testing.assert_array_equal(got, want)
    for p in range(P):
        b_edge = plan.bond_global_edge[p]
        np.testing.assert_array_equal(
            got[p, :len(b_edge)], b_edge[:, None].astype(np.float32) + np.arange(3))
    atoms = np.random.default_rng(1).normal(size=(P * tg.n_cap, 5)).astype(np.float32)
    (a1, a2), (b1,) = lg.exchange_all((torch.from_numpy(atoms), torch.from_numpy(atoms[:, :2])),
                                      (_flat(bonds),))
    torch.testing.assert_close(a1, lg.halo_exchange(torch.from_numpy(atoms)), rtol=0, atol=0)
    torch.testing.assert_close(a2, a1[:, :2], rtol=0, atol=0)
    torch.testing.assert_close(b1.reshape(bonds.shape), torch.from_numpy(got), rtol=0, atol=0)


def _flat_edges(g, x):
    """A (P, E_cap, ...) per-edge array in the flattened edge layout: per
    segment, every partition's real rows in turn (the padding, zero here,
    at the segment's tail)."""
    s, P, m = g.e_split, g.num_partitions, torch.from_numpy(g.edge_mask)
    real = [x[p, sl][m[p, sl]] for sl in (slice(0, s), slice(s, None))
            for p in range(P)]
    out = x.new_zeros((P * g.e_cap,) + x.shape[2:])
    out[g.flat["edge_mask"]] = torch.cat(real)
    return out


@pytest.mark.parametrize("P", [3])
def test_split_edge_sum_matches_jax(P):
    """``aggregate_edges`` on the flattened split layout (one sum per
    segment) equals the JAX package's per-partition split sums."""
    jg, _, _, tg, _ = _graphs(P)
    data = np.random.default_rng(2).normal(size=(P, tg.e_cap, 3)).astype(np.float32)
    want = np.asarray(_jax_sharded(
        jg, lambda lg, x: lg.aggregate_edges(x, lg.edge_mask)[None], jnp.asarray(data)))
    lg = local_graph_from_stacked(tg)
    got = lg.aggregate_edges(_flat_edges(tg, torch.from_numpy(data)), lg.edge_mask)
    np.testing.assert_allclose(got.reshape(want.shape).numpy(), want, atol=1e-5)


def test_split_messages_read_the_right_rows(monkeypatch):
    """``overlapped_edge_sum`` on the split layout equals the unsplit sum of
    the messages over every edge at the exchanged rows: the interior
    segment never reads a halo row of ``v_pre`` (filled with 1e6 here),
    the frontier reads the exchanged rows at src; ``aggregate_edge_messages``
    hands each segment one shared index slice for inputs gathered at one
    index tensor (the TensorNet interaction's kernel needs it)."""
    _, _, _, tg, _ = _graphs(2, bond=True)
    lg = local_graph_from_stacked(tg)
    rng = np.random.default_rng(3)
    C, n, e = 8, lg.n_cap, lg.e_cap
    weights = gated_mlp_weights(CHGNet(CHGNetConfig(num_species=4, units=C)).init(0)
                                ["atom_blocks"][0]["node_update"])
    v = torch.from_numpy(rng.normal(size=(n, C)).astype(np.float32))
    v_post = lg.halo_exchange(v)
    v_pre = torch.where(lg.owned_mask[:, None], v_post, torch.full_like(v, 1e6))
    edge = torch.from_numpy(rng.normal(size=(e, C)).astype(np.float32))
    mask = lg.edge_mask
    got = lg.overlapped_edge_sum(CHGNET_ATOM_CONV, v_pre, v_post, (edge,), mask, weights)
    want = masked_segment_sum(chgnet_atom_message(
        v_post[lg.edge_src.long()], v_post[lg.edge_dst.long()], edge, weights=weights),
        lg.edge_dst.long(), n, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert bool(torch.isfinite(got).all())

    seen = []
    real = halo.fused_edge_aggregate

    def spy(message, inputs, *args, **kw):
        idxs = [i.idx for i in inputs if hasattr(i, "idx")]
        seen.append(all(t is idxs[0] for t in idxs))
        return real(message, inputs, *args, **kw)

    monkeypatch.setattr(halo, "fused_edge_aggregate", spy)
    f = torch.from_numpy(rng.normal(size=(e, C, 3)).astype(np.float32))
    rows = [torch.from_numpy(rng.normal(size=(n,) + s + (C,)).astype(np.float32))
            for s in ((), (3,), (6,))]
    got = lg.aggregate_edge_messages(
        TENSORNET_INTERACTION, [f] + [halo.Gather(r, lg.edge_src) for r in rows], mask)
    assert seen == [True, True]
    src = lg.edge_src.long()
    want = masked_segment_sum(tensornet_interaction_message(f, *(r[src] for r in rows)),
                              lg.edge_dst.long(), n, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
