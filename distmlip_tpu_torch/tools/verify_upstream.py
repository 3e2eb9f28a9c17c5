"""Upstream-parity check of a converted checkpoint, on the port.

    python -m distmlip_tpu_torch.tools.verify_upstream <family> <ckpt> \
        [--set key=val ...] [--device cuda|cpu] [--out report.json]

Port of ``distmlip_tpu/tools/verify_upstream.py``. family: mace | chgnet |
tensornet | escn. <ckpt> is an upstream torch checkpoint, or an npz from
``tools/export_upstream.py``.

  1. read    the state dict (``export_upstream.load_state_dict``, or the
             npz; mace checkpoints go through ``export_mace``, which needs
             mace-torch and e3nn);
  2. infer   the model config from tensor SHAPES (anything not
             shape-derivable takes the upstream default and is printed;
             override with --set key=val);
  3. convert ``from_torch`` with strict=True and the constant checks;
  4. ours    E/F on a fixed fixture crystal through ``DistPotential`` at
             P=1 and P=2 (internal consistency), on ``--device`` (the card
             unless "cpu");
  5. upstream the SAME fixture through the live upstream package
             (mace-torch / matgl / fairchem, with ase). Without it,
             ``eval_upstream`` raises ``UpstreamUnavailable`` naming the
             missing module, and the run reports the comparison skipped.

Exit codes: 0 PASS, 1 FAIL, 2 usage, 3 converted and self-consistent but
the upstream package is not importable. Thresholds: |dE|/atom < 1e-4 eV and
max |dF| < 1e-3 eV/Å against upstream (float32 evaluation).
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile

import numpy as np

PASS_DE = 1e-4   # eV/atom vs upstream
PASS_DF = 1e-3   # eV/Å max component vs upstream
SELF_DE = 1e-5   # eV/atom P=2 vs P=1 (internal)

# one task for both sides of the eSCN/UMA check: the local dataset index
# and the upstream calculator's task_name must select the same embedding
UMA_PARITY_TASK = "omat"


class UpstreamUnavailable(RuntimeError):
    """The upstream package the comparison needs is not importable."""


def _log(stage, msg):
    print(f"[{stage}] {msg}", flush=True)


def make_fixture(cutoff: float, atomic_numbers, seed: int = 0):
    """Perturbed fcc supercell, elongated so P=2 slabs satisfy
    box_x / 2 > 2 (cutoff + skin)."""
    from .. import geometry

    rng = np.random.default_rng(seed)
    a = 4.1
    nx = max(3, math.ceil(2 * 2 * (cutoff + 0.6) / a))
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lattice = geometry.make_supercell(unit, np.eye(3) * a, (nx, 2, 2))
    cart = geometry.frac_to_cart(frac, lattice) + rng.normal(0, 0.06, (len(frac), 3))
    zs = np.asarray(atomic_numbers)
    numbers = zs[rng.integers(0, len(zs), len(cart))]
    return numbers.astype(np.int64), cart, lattice


# ---------------------------------------------------------------------------
# config inference from state-dict shapes (loud about what it assumes)
# ---------------------------------------------------------------------------


def _parse_value(v):
    """A --set value: bool words, int, float, a comma tuple of ints, else the
    raw string. A malformed comma tuple raises ValueError."""
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if "," in v:
        try:
            return tuple(int(x) for x in v.split(","))
        except ValueError:
            raise ValueError(
                f"comma value {v!r} must be a tuple of ints (e.g. 2,2,1)") from None
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def _apply_overrides(kw, overrides, assumed):
    for k, v in overrides.items():
        if k in assumed:
            assumed.remove(k)
        kw[k] = _parse_value(v)
    return kw


def _log_assumed(assumed, notes):
    for k in assumed:
        _log("infer", f"ASSUMED {k}{notes.get(k, '')}; override with --set {k}=val")


def infer_mace(sd, overrides):
    from ..models import MACE, MACEConfig

    zs = np.asarray(sd["atomic_numbers"]).astype(int)
    S = len(zs)
    C = np.asarray(sd["node_embedding.linear.weight"]).size // S
    num_bessel = np.asarray(sd["radial_embedding.bessel_fn.bessel_weights"]).size
    layer_keys = sorted(k for k in sd if k.startswith("interactions.0.conv_tp_weights.layer")
                        and k.endswith(".weight"))
    radial_mlp = int(np.asarray(sd[layer_keys[0]]).shape[1])
    n_inter = int(np.asarray(sd["num_interactions"]))
    # the path count of the LAST interaction, whose richer l_h set tells the
    # l_max candidates apart where the scalar-input first one cannot
    last_keys = sorted(k for k in sd
                       if k.startswith(f"interactions.{n_inter - 1}.conv_tp_weights.layer")
                       and k.endswith(".weight"))
    n_paths_c = int(np.asarray(sd[last_keys[-1]]).shape[1])
    corr = len([k for k in sd if k.startswith(
        "products.0.symmetric_contractions.contractions.0.U_matrix_")])
    u1 = np.asarray(sd["products.0.symmetric_contractions.contractions.0.U_matrix_1"])
    a_lmax = int(round(np.sqrt(u1.shape[1]))) - 1
    n_contr = len({k.split(".")[4] for k in sd
                   if k.startswith("products.0.symmetric_contractions.contractions.")})
    H = (np.asarray(sd["readouts.0.linear.weight"]).size // C
         if "readouts.0.linear.weight" in sd else 1)
    kw = dict(
        num_species=S, channels=C, a_lmax=a_lmax, hidden_lmax=n_contr - 1, correlation=corr,
        num_interactions=n_inter, num_bessel=num_bessel, radial_mlp=radial_mlp,
        radial_layers=len(layer_keys) - 1, cutoff=float(np.asarray(sd["r_max"])),
        cutoff_p=int(np.asarray(sd["radial_embedding.cutoff_fn.p"])),
        avg_num_neighbors=float(np.asarray(sd["interactions.0.avg_num_neighbors"]))
        if "interactions.0.avg_num_neighbors" in sd else 14.0,
        num_heads=H, zbl="pair_repulsion_fn.a_exp" in sd, atomic_numbers=tuple(zs.tolist()),
    )
    assumed = ["avg_num_neighbors"] if "interactions.0.avg_num_neighbors" not in sd else []
    if "l_max" in overrides:
        kw["l_max"] = int(overrides["l_max"])
    else:
        # l_max is not a tensor shape: match the message-path count the
        # radial MLP's output width encodes
        matches = [cand for cand in range(5)
                   if len(MACE(MACEConfig(l_max=cand, **kw)).msg_paths[n_inter - 1]) * C
                   == n_paths_c]
        if not matches:
            raise ValueError(f"could not infer l_max: no candidate yields {n_paths_c // C} "
                             f"message paths; pass --set l_max=N")
        # past the saturation point extra harmonics feed no CG path, so the
        # candidates are the same model: the smallest is canonical
        if len(matches) > 1:
            _log("infer", f"l_max candidates {matches} are path-equivalent; using {matches[0]}")
        kw["l_max"] = matches[0]
    kw = _apply_overrides(kw, {k: v for k, v in overrides.items() if k != "l_max"}, assumed)
    return MACEConfig(**kw), assumed, zs, {}


def infer_chgnet(sd, overrides):
    from ..models import CHGNetConfig

    p = "model." if any(k.startswith("model.") for k in sd) else ""
    S, units = np.asarray(sd[p + "atom_embedding.weight"]).shape
    num_rbf = np.asarray(sd[p + "bond_expansion.frequencies"]).size
    # the fourier basis stores max_f + 1 frequencies (a constant + max_f waves)
    nf = np.asarray(sd[p + "angle_expansion.frequencies"]).size - 1
    n_blocks = len({k[len(p):].split(".")[1] for k in sd
                    if k.startswith(p + "atom_graph_layers.")})
    kw = dict(num_species=S, units=units, num_rbf=num_rbf, num_angle=nf, num_blocks=n_blocks,
              cutoff=6.0, bond_cutoff=3.0)
    assumed = ["cutoff", "bond_cutoff"]  # matgl hyperparameters, not tensors
    kw = _apply_overrides(kw, overrides, assumed)
    return CHGNetConfig(**kw), assumed, np.arange(1, S + 1), {}


def infer_tensornet(sd, overrides):
    from ..models import TensorNetConfig

    p = "model." if any(k.startswith("model.") for k in sd) else ""
    emb = np.asarray(sd[p + "tensor_embedding.emb.weight"])
    S, units = emb.shape[0], emb.shape[1]
    num_rbf = np.asarray(sd[p + "tensor_embedding.distance_proj1.weight"]).shape[1]
    n_layers = len({k[len(p):].split(".")[1] for k in sd if k.startswith(p + "layers.")})
    kw = dict(num_species=S, units=units, num_rbf=num_rbf, num_layers=n_layers, cutoff=5.0)
    assumed = ["cutoff"]
    kw = _apply_overrides(kw, overrides, assumed)
    return TensorNetConfig(**kw), assumed, np.arange(1, S + 1), {}


def infer_escn(sd, overrides):
    from ..models import ESCNMDConfig

    p = "backbone." if any(k.startswith("backbone.") for k in sd) else ""
    Z, C = np.asarray(sd[p + "sphere_embedding.weight"]).shape
    CE = np.asarray(sd[p + "source_embedding.weight"]).shape[1]
    offsets = np.asarray(sd[p + "distance_expansion.offset"]).ravel()
    n_blocks = len({int(k[len(p):].split(".")[1]) for k in sd if k.startswith(p + "blocks.")})
    # lmax from the norm's affine weight (lmax+1, C); mmax from the
    # so2_m_conv count; experts from a leading axis on fc_m0
    lmax = np.asarray(sd[p + "blocks.0.norm_1.affine_weight"]).shape[0] - 1
    mmax = len({k for k in sd if k.startswith(p + "blocks.0.so2_conv_1.so2_m_conv.")
                and k.endswith(".fc.weight")})
    fc2 = np.asarray(sd[p + "blocks.0.so2_conv_2.fc_m0.weight"])
    H = fc2.shape[-1] // (lmax + 1)
    nq = np.asarray(sd[p + "csd_embedding.charge_embedding.weight"]).shape[0]
    ns = np.asarray(sd[p + "csd_embedding.spin_embedding.weight"]).shape[0]
    nd = np.asarray(sd[p + "csd_embedding.dataset_embedding.weight"]).shape[0]
    kw = dict(max_num_elements=Z, sphere_channels=C, lmax=lmax, mmax=mmax,
              num_layers=n_blocks, hidden_channels=H, edge_channels=CE,
              num_distance_basis=offsets.size, num_experts=fc2.shape[0] if fc2.ndim == 3 else 1,
              num_charges=nq, charge_min=-(nq // 2), num_spins=ns, num_datasets=nd,
              cutoff=float(offsets[-1]), avg_degree=14.0)
    assumed = ["avg_degree", "basis_width_scalar", "charge_min"]
    notes = {"basis_width_scalar": " (=2.0, lineage default)",
             "charge_min": f" (=-{nq // 2}, centered range)"}
    kw = _apply_overrides(kw, overrides, assumed)
    return ESCNMDConfig(**kw), assumed, np.arange(1, Z), notes


# ---------------------------------------------------------------------------
# our side: convert + evaluate through the public DistPotential surface
# ---------------------------------------------------------------------------


def _model_for(family, cfg):
    from .. import models

    cls = {"mace": models.MACE, "chgnet": models.CHGNet, "tensornet": models.TensorNet,
           "escn": models.ESCNMD}[family]
    return cls(cfg)


def species_map(family, cfg, numbers):
    """Atomic number -> the model's species index: MACE carries its own Z
    table; fairchem eSCN/UMA embeddings are indexed by the raw atomic
    number; the matgl families by Z - 1 (Z-ordered element_types)."""
    smap = np.full(int(numbers.max()) + 1, -1, np.int32)
    zs = sorted(set(numbers.tolist()))
    if family == "mace" and cfg.atomic_numbers is not None:
        for i, z in enumerate(cfg.atomic_numbers):
            if z < len(smap):
                smap[z] = i
    elif family == "escn":
        for z in zs:
            smap[z] = min(z, cfg.max_num_elements - 1)
    else:
        for z in zs:
            smap[z] = min(z - 1, cfg.num_species - 1)
    return smap


def eval_ours(family, cfg, sd, numbers, cart, lattice, info, device="cuda"):
    """Convert ``sd`` onto the family's model and evaluate the fixture at
    P = 1 and P = 2 on ``device``; returns P = 1's (energy, forces)."""
    from ..calculators import Atoms, DistPotential
    from ..models.convert import from_torch

    model = _model_for(family, cfg)
    params, report = from_torch(family, sd, model.init(0), model=model)
    _log("convert", f"mapped={report['mapped']} unused={len(report['unused_torch'])}")
    atoms = Atoms(numbers=numbers, positions=cart, cell=lattice, info=dict(info))
    smap = species_map(family, cfg, numbers)
    out = {}
    for P in (1, 2):
        r = DistPotential(model, params, num_partitions=P, species_map=smap,
                          device=device).calculate(atoms)
        out[P] = (float(r["energy"]), np.asarray(r["forces"]))
    de_self = abs(out[2][0] - out[1][0]) / len(numbers)
    _log("ours", f"P=1 E={out[1][0]:.6f} eV; P=2 dE/atom={de_self:.2e}")
    if de_self > SELF_DE:
        raise AssertionError(f"internal P=2 vs P=1 disagreement {de_self:.2e} eV/atom")
    return out[1]


# ---------------------------------------------------------------------------
# upstream side (needs the upstream package and ase)
# ---------------------------------------------------------------------------


def eval_upstream(family, ckpt, numbers, cart, lattice, info):
    """(energy, forces) of the fixture through the live upstream package.
    Raises ``UpstreamUnavailable`` when the package (or ase) is not
    importable, or when ``ckpt`` is an npz (upstream needs its own
    checkpoint format to rebuild the model)."""
    if ckpt.endswith(".npz"):
        raise UpstreamUnavailable(
            "npz input: pass the original upstream checkpoint to run the comparison")
    try:
        import ase

        if family == "mace":
            from mace.calculators import MACECalculator
        elif family in ("chgnet", "tensornet"):
            import matgl
            from matgl.ext.ase import PESCalculator
        else:
            from fairchem.core import FAIRChemCalculator
            from fairchem.core.units.mlip_unit import load_predict_unit
    except ImportError as e:
        raise UpstreamUnavailable(
            f"the upstream package for {family!r} is not importable ({e}); run "
            f"this where it is installed") from e
    atoms = ase.Atoms(numbers=numbers, positions=cart, cell=lattice, pbc=True)
    if family == "mace":
        atoms.calc = MACECalculator(model_paths=ckpt, device="cpu", default_dtype="float64")
    elif family in ("chgnet", "tensornet"):
        atoms.calc = PESCalculator(matgl.load_model(ckpt))
    else:
        atoms.info.update(info)
        atoms.calc = FAIRChemCalculator(load_predict_unit(ckpt), task_name=UMA_PARITY_TASK)
    return float(atoms.get_potential_energy()), atoms.get_forces()


# ---------------------------------------------------------------------------

_INFER = {"mace": infer_mace, "chgnet": infer_chgnet, "tensornet": infer_tensornet,
          "escn": infer_escn}


def read_state_dict(family, ckpt):
    """The checkpoint's tensors: an npz as it is, a mace model through
    ``export_mace`` (for its CG calibration), others as torch tensors."""
    from .export_upstream import export_mace, load_state_dict

    if ckpt.endswith(".npz"):
        return dict(np.load(ckpt))
    if family != "mace":
        return load_state_dict(ckpt)
    with tempfile.TemporaryDirectory() as d:
        npz = os.path.join(d, "mace.npz")
        export_mace(ckpt, npz)
        return dict(np.load(npz))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides, out_json, device = {}, None, "cuda"
    try:
        while "--set" in argv:
            i = argv.index("--set")
            k, v = argv[i + 1].split("=", 1)
            overrides[k] = v
            del argv[i:i + 2]
        for flag in ("--out", "--device"):
            if flag in argv:
                i = argv.index(flag)
                if flag == "--out":
                    out_json = argv[i + 1]
                else:
                    device = argv[i + 1]
                del argv[i:i + 2]
    except (IndexError, ValueError):
        print(__doc__)
        print("ERROR: --set expects key=val, --out a path and --device a device")
        return 2
    # every --set value is checked before any work
    for k, v in overrides.items():
        try:
            _parse_value(v)
        except ValueError as e:
            print(__doc__)
            print(f"ERROR: --set {k}={v}: {e}")
            return 2
    if len(argv) != 2 or argv[0] not in _INFER:
        print(__doc__)
        return 2
    family, ckpt = argv
    _log("verify_upstream", f"family={family} checkpoint={ckpt} device={device}")

    sd = read_state_dict(family, ckpt)
    _log("read", f"{len(sd)} tensors")
    cfg, assumed, zs, notes = _INFER[family](sd, overrides)
    _log("infer", f"{cfg}")
    _log_assumed(assumed, notes)

    # eSCN conditions on the same task as the upstream evaluation (a
    # single-dataset checkpoint has index 0 only)
    if family == "escn":
        from ..calculators.calculator import UMA_TASK_DATASETS

        ds = min(UMA_TASK_DATASETS[UMA_PARITY_TASK], getattr(cfg, "num_datasets", 1) - 1)
        info = {"charge": 0, "spin": 0, "dataset": ds}
    else:
        info = {}
    numbers, cart, lattice = make_fixture(cfg.cutoff, zs)
    e_ours, f_ours = eval_ours(family, cfg, sd, numbers, cart, lattice, info, device)

    result = {"family": family, "checkpoint": ckpt, "n_atoms": len(numbers),
              "energy_ours": e_ours, "assumed": assumed}
    try:
        e_up, f_up = eval_upstream(family, ckpt, numbers, cart, lattice, info)
    except UpstreamUnavailable as e:
        _log("upstream", f"SKIP ({e})")
        _log("RESULT", "CONVERT-OK-UPSTREAM-SKIPPED")
        result["status"] = "upstream_skipped"
        rc = 3
    else:
        de = abs(e_ours - e_up) / len(numbers)
        df = float(np.abs(f_ours - np.asarray(f_up)).max())
        result.update(energy_upstream=e_up, de_per_atom=de, df_max=df)
        ok = de < PASS_DE and df < PASS_DF
        _log("compare", f"dE/atom={de:.3e} eV (<{PASS_DE}) dF_max={df:.3e} eV/A (<{PASS_DF})")
        _log("RESULT", "PASS" if ok else "FAIL")
        result["status"] = "pass" if ok else "fail"
        rc = 0 if ok else 1
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=1)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
