"""Shared set-up of the port's training tests (``tests/test_torch_train_*.py``,
``tests/test_torch_trainer.py``): labelled samples, the four families at
small widths, and the parameter trees carried between the packages.

The samples are those of ``tests/test_train_subsystem.py``: 32-atom fcc
cells (a = 3.6 Å, 2 x 2 x 2) rattled by 0.05 Å, three species, random
energies and forces from a numpy seed. The models are small: TensorNet as
``tests/test_train_subsystem.py:34`` (units 8), a 2-interaction MACE at 8
channels, CHGNet with its bond graph (units 8, 2 blocks, as
``test_overfit_tiny_dataset_chgnet``) and an eSCN at 8 channels, l_max 2,
2 experts. Each JAX model runs on the port's ``init`` as numpy (the two
packages share the tree layout), so both sides start from the same
weights without a JAX ``init``.
"""

import numpy as np

UNIT = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
CUTOFF = 3.2
BOND_CUTOFF = 2.6

FAMILIES = {
    "tensornet": ("TensorNet", dict(num_species=3, units=8, num_rbf=4, num_layers=1,
                                    cutoff=CUTOFF), {}),
    "mace": ("MACE", dict(num_species=3, channels=8, l_max=1, a_lmax=1, hidden_lmax=1,
                          correlation=2, num_interactions=2, num_bessel=4, radial_mlp=8,
                          cutoff=CUTOFF, avg_num_neighbors=12.0, edge_chunk=0), {}),
    "chgnet": ("CHGNet", dict(num_species=3, units=8, num_rbf=4, num_blocks=2,
                              cutoff=CUTOFF, bond_cutoff=BOND_CUTOFF),
               {"use_bond_graph": True, "bond_cutoff": BOND_CUTOFF}),
    "escn": ("ESCN", dict(num_species=3, channels=8, l_max=2, num_layers=2, num_bessel=4,
                          num_experts=2, cutoff=CUTOFF, avg_num_neighbors=12.0,
                          edge_chunk=0), {}),
}


def species_fn(z):
    return (np.asarray(z) - 1).astype(np.int32)


def make_samples(Sample, Atoms, rng, n=8, reps=(2, 2, 2), a=3.6, stress=False):
    """``tests/test_train_subsystem.py:make_samples`` for either package's
    ``Sample`` and ``Atoms``."""
    from distmlip_tpu_torch import geometry

    frac, lat = geometry.make_supercell(UNIT, np.eye(3) * a, reps)
    out = []
    for _ in range(n):
        cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.05, (len(frac), 3))
        atoms = Atoms(numbers=rng.integers(1, 4, len(frac)), positions=cart, cell=lat)
        out.append(Sample(atoms, float(rng.normal()),
                          rng.normal(0, 0.1, (len(frac), 3)).astype(np.float32),
                          rng.normal(0, 0.01, (3, 3)).astype(np.float32) if stress else None))
    return out


def both_samples(n=8, seed=7, **kw):
    """The same samples as the port's and the JAX package's ``Sample``s."""
    from distmlip_tpu.calculators import Atoms as JAtoms
    from distmlip_tpu.train import Sample as JSample
    from distmlip_tpu_torch.calculators import Atoms
    from distmlip_tpu_torch.train import Sample

    return (make_samples(Sample, Atoms, np.random.default_rng(seed), n, **kw),
            make_samples(JSample, JAtoms, np.random.default_rng(seed), n, **kw))


def port_model(family, **over):
    import distmlip_tpu_torch.models as m

    name, cfg, _ = FAMILIES[family]
    return getattr(m, name)(getattr(m, name + "Config")(**{**cfg, **over}))


def jax_model(family, **over):
    import distmlip_tpu.models as m

    name, cfg, _ = FAMILIES[family]
    return getattr(m, name)(getattr(m, name + "Config")(**{**cfg, **over}))


def numpy_tree(tree):
    """A tree of torch tensors (or arrays) as numpy, structure kept."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    if tree is None:
        return None
    if hasattr(tree, "detach"):
        return tree.detach().float().numpy().copy()
    return np.asarray(tree)


def paths(tree, prefix=""):
    """{slash path: numpy leaf} of a tree (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(paths(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(paths(v, f"{prefix}{i}/"))
        return out
    if tree is None:
        return {}
    return {prefix[:-1]: np.asarray(numpy_tree(tree), dtype=np.float64)}


def rel_l2(a: dict, b: dict) -> float:
    """|a - b| / |b| over every leaf of two path dicts with the same keys."""
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in a)
    den = sum(float(np.sum(b[k] ** 2)) for k in b)
    return (num / max(den, 1e-300)) ** 0.5


def jax_micro(batch, a=0):
    """Micro-batch ``a`` of a JAX ``TrainBatch`` (leading axis dropped)."""
    import jax

    return (jax.tree.map(lambda x: x[a], batch.graphs),
            jax.tree.map(lambda x: x[a], batch.targets))
