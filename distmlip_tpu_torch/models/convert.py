"""Weight ingestion from upstream torch checkpoints.

Port of ``distmlip_tpu/models/convert.py``: map an upstream ``state_dict``
(mace-torch ``ScaleShiftMACE``, matgl CHGNet and TensorNet, fairchem
``eSCNMDBackbone``) onto the port's parameter trees, so a published
checkpoint runs here without JAX. The maps are the JAX package's, rule for
rule, and run in numpy (float64 where the checkpoint is, each value cast
once to its leaf's dtype), so a converted tree equals ``params_from_numpy``
of the JAX package's converted tree bit for bit
(``tests/test_torch_convert.py``).

Generic machinery here; per-architecture name maps live in ``MAPPINGS``.
``convert`` reports unmapped tensors, so a partial map fails loudly instead
of giving a half-initialised model. The helpers the maps call are the
port's own: ``ops/nn.silu_2mom_gain``, ``ops/so3.symmetric_coupling_basis``
(the U bases the port's MACE evaluates with), ``models/mace._message_paths``
and ``models/pair``'s ZBL tables.
"""

from __future__ import annotations

import re
import warnings
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..utils.checkpoint import params_from_numpy


def _t(x):
    """torch tensor / numpy -> numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


@dataclass
class Rule:
    """Maps one torch tensor onto one parameter-tree leaf path.

    path: tuple of keys/indices into the parameter tree. ``path=None``
    marks a consume-only rule: the tensor is accounted for (buffers such as
    cutoff constants, e3nn output masks, U matrices) and ``transform``, if
    given, runs as a validation hook.
    transform: applied to the torch array (``linear_rule`` transposes:
    torch's nn.Linear stores (out, in), ``ops/nn.linear`` takes (in, out)).
    """

    torch_name: str
    path: tuple | None
    transform: Callable[[np.ndarray], np.ndarray] | None = None


def set_in(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node[p]
    leaf = node[path[-1]]
    if np.shape(leaf) != value.shape:
        raise ValueError(
            f"shape mismatch at {path}: torch {value.shape} vs model {np.shape(leaf)}")
    node[path[-1]] = value.astype(np.asarray(leaf).dtype)


def convert(state_dict: dict, params, rules: list[Rule], strict: bool = True):
    """Apply mapping rules to a numpy parameter tree (in place); returns
    ``(params, report)`` with ``report = {"mapped": n, "unused_torch":
    [names]}``. ``strict`` raises on a missing or an unmapped tensor."""
    used = set()
    for r in rules:
        if r.torch_name not in state_dict:
            if strict:
                raise KeyError(f"torch checkpoint missing {r.torch_name!r}")
            continue
        arr = _t(state_dict[r.torch_name])
        if r.path is None:
            if r.transform is not None:
                r.transform(arr)  # validation hook
            used.add(r.torch_name)
            continue
        if r.transform is not None:
            arr = r.transform(arr)
        set_in(params, r.path, arr)
        used.add(r.torch_name)
    unused = sorted(set(state_dict) - used)
    report = {"mapped": len(used), "unused_torch": unused}
    if strict and unused:
        raise ValueError(f"{len(unused)} torch tensors unmapped (first 10): {unused[:10]}")
    return params, report


def linear_rule(torch_prefix: str, path: tuple, bias: bool = True) -> list[Rule]:
    """nn.Linear -> {'w': (in, out), 'b': (out,)}"""
    rules = [Rule(f"{torch_prefix}.weight", path + ("w",), lambda a: a.T)]
    if bias:
        rules.append(Rule(f"{torch_prefix}.bias", path + ("b",), None))
    return rules


MAPPINGS: dict[str, Callable] = {}


def register_mapping(name: str):
    def deco(fn):
        MAPPINGS[name] = fn
        return fn

    return deco


def zeros_like_tree(tree):
    """A numpy tree of zeros with ``tree``'s structure, shapes and dtypes
    (``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zeros_like_tree(v) for v in tree)
    return np.zeros_like(np.asarray(tree))


def _numpy_tree(tree):
    """The parameter tree with numpy leaves (copies), list positions kept:
    the form the maps write into."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return np.array(tree)


def _tree_device(tree):
    """The device of the tree's first tensor leaf (the CPU without one)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dev = _tree_device(v)
            if dev is not None:
                return dev
        return None
    return tree.device if isinstance(tree, torch.Tensor) else None


# ---------------------------------------------------------------------------
# MACE (mace-torch ScaleShiftMACE) mapping
# ---------------------------------------------------------------------------

def _silu_2mom_gain() -> float:
    """e3nn's normalize2mom(silu) constant, shared with ``ops/nn.py``'s
    variance-preserving init. e3nn estimates the same constant by sampling,
    so folded weights agree with upstream's to ~1e-3 relative."""
    from ..ops.nn import silu_2mom_gain

    return silu_2mom_gain()


def _scaled(alpha):
    return lambda a: a * alpha


def _find_u_buffer(sd: dict, prefix: str, S_A: int, nu: int):
    """Locate the U-matrix buffer for correlation ``nu`` under a mace
    symmetric-contraction prefix and canonicalise it to ((S_A^nu * d), k):
    upstream stores (d?, S..., S, k) with the output axis leading; ours is
    (S,)*nu + (d, k). A key whose trailing digits name the correlation
    (``U_matrix_{nu}``) first, then matching by axis shapes."""
    candidates = [
        k for k in sd
        if k.startswith(prefix)
        and ("U_matrix" in k.rsplit(".", 1)[-1] or "U_tensors" in k.rsplit(".", 1)[-1])
    ]

    def canonical(arr):
        s_axes = [i for i, s in enumerate(arr.shape) if s == S_A][:nu]
        if len(s_axes) < nu:
            return None
        d_axes = [i for i in range(arr.ndim - 1) if i not in s_axes and i != arr.ndim - 1]
        if len(d_axes) > 1:
            return None
        can = np.transpose(arr, s_axes + d_axes + [arr.ndim - 1])
        return can.reshape(-1, can.shape[-1])

    for key in candidates:
        m = re.search(r"(\d+)$", key)
        if m and int(m.group(1)) == nu:
            can = canonical(_t(sd[key]))
            if can is not None:
                return can
    for key in candidates:
        arr = _t(sd[key])
        if sum(1 for s in arr.shape if s == S_A) == nu:
            can = canonical(arr)
            if can is not None:
                return can
    return None


def _basis_change(U_ours: np.ndarray, U_up_flat: np.ndarray) -> np.ndarray:
    """T with U_up = U_ours @ T (both bases of the same coupling space).

    U_ours has orthonormal columns, so T = U_ours^T U_up, exact whenever
    upstream's basis spans the same space; the residual check fails loudly
    otherwise."""
    flat = U_ours.reshape(-1, U_ours.shape[-1])
    T = flat.T @ U_up_flat
    resid = np.linalg.norm(U_up_flat - flat @ T)
    denom = max(np.linalg.norm(U_up_flat), 1e-12)
    if resid / denom > 1e-5:
        raise ValueError(
            f"upstream U matrix is not in the span of the native symmetric "
            f"basis (relative residual {resid / denom:.2e}); irreps/"
            f"correlation mismatch?")
    return T


def _path_signs(sd: dict, inter: dict, a_ls: tuple, paths=None):
    """Per-path +-1 from ``__cg_sign__`` calibration entries, in the message
    path order (None when the export carries no calibration). ``paths`` is
    authoritative when the caller passes the model; otherwise the set is
    reconstructed from the weight shapes (it must be unambiguous)."""
    if not any(k.startswith("__cg_sign__") for k in sd):
        return None
    if paths is None:
        from .mace import _message_paths

        h_ls_in = sorted(int(l) for l in inter["lin_up"])
        C = np.shape(inter["lin_up"][str(h_ls_in[0])]["w"])[0]
        n_paths = np.shape(inter["radial"][-1]["w"])[1] // C
        matching = {
            tuple(p) for lm in range(7)
            if len(p := _message_paths(h_ls_in, lm, list(a_ls))) == n_paths
        }
        if len(matching) != 1:
            raise ValueError(
                "cannot reconstruct the message-path set from weight shapes; "
                "pass the model to from_torch(..., model=model) so CG sign "
                "calibration can be applied unambiguously")
        paths = list(next(iter(matching)))
    signs = np.ones(len(paths))
    for i, (lh, ly, lo) in enumerate(paths):
        key = f"__cg_sign__.{lh}.{ly}.{lo}"
        if key not in sd:
            # calibration IS present but misses this path: defaulting to +1
            # would be the silent wrong-sign failure calibration exists to
            # prevent
            raise ValueError(
                f"export carries __cg_sign__ calibration but no entry for "
                f"message path (l_h={lh}, l_Y={ly}, l_out={lo}); re-export "
                f"with tools/export_upstream.py covering l_max >= {max(lh, ly, lo)}")
        signs[i] = float(np.ravel(_t(sd[key]))[0])
    return signs


@register_mapping("mace")
def mace_mapping(params, sd, model=None):
    """mace-torch ``ScaleShiftMACE.state_dict()`` -> MACE params
    (``distmlip_tpu/models/convert.py:236-549``).

    The MACE-MP-0 family layout: e3nn flat Linear weights split into
    per-irrep blocks with the 1/sqrt(fan_in) path normalisation folded in;
    the radial FullyConnectedNet with e3nn's normalize2mom(silu) gain folded
    into post-activation layers; the symmetric-contraction weights
    basis-changed exactly against the checkpoint's own U-matrix buffers
    (``_basis_change``); CG sign conventions calibrated by
    ``tools/export_upstream.py``'s ``__cg_sign__`` entries when present.
    """
    from ..ops.so3 import symmetric_coupling_basis

    S, C = np.shape(params["species_emb"]["w"])
    H = np.shape(params["species_ref"]["w"])[0]
    gain = _silu_2mom_gain()
    rules: list[Rule] = []

    def consume(name, validate=None):
        if name in sd:
            rules.append(Rule(name, None, validate))

    def expect(name, value, what, atol=1e-6):
        """Checkpoint constants must agree with the model config: a silent
        mismatch (cutoff, envelope power, bessel frequencies) would evaluate
        the converted weights with the wrong physics."""
        def check(a, _v=np.asarray(value, dtype=np.float64)):
            got = np.asarray(a, dtype=np.float64).reshape(_v.shape)
            if not np.allclose(got, _v, atol=atol):
                raise ValueError(
                    f"checkpoint {what} = {got} does not match the model "
                    f"config ({_v}); rebuild the model with matching hyperparameters")
        return check

    cfg = model.cfg if model is not None else None
    if cfg is None:
        warnings.warn(
            "from_torch('mace', ...) called without model=: checkpoint "
            "constants (cutoff, envelope power p, bessel frequencies, "
            "avg_num_neighbors) will NOT be validated against the model "
            "config; pass model=your_mace_instance", stacklevel=3)

    # model-level buffers
    consume("atomic_numbers",
            expect("atomic_numbers", cfg.atomic_numbers, "atomic_numbers")
            if cfg is not None and cfg.atomic_numbers is not None else None)
    consume("r_max", expect("r_max", cfg.cutoff, "r_max (cutoff)") if cfg is not None else None)
    for name in ("num_interactions", "heads"):
        consume(name)

    # embeddings
    rules.append(Rule("node_embedding.linear.weight", ("species_emb", "w"),
                      lambda a: a.reshape(S, C) / np.sqrt(S)))
    rules.append(Rule("atomic_energies_fn.atomic_energies", ("species_ref", "w"),
                      lambda a: np.broadcast_to(a.reshape(-1, S), (H, S)).copy()))
    consume(
        "radial_embedding.bessel_fn.bessel_weights",
        expect("bessel_weights", np.pi * np.arange(1, cfg.num_bessel + 1),
               "bessel frequencies (this framework's basis is fixed n*pi; a "
               "checkpoint with trained frequencies cannot be represented)", atol=1e-4)
        if cfg is not None else None)
    consume("radial_embedding.cutoff_fn.p",
            expect("p", float(cfg.cutoff_p), "cutoff envelope power p")
            if cfg is not None else None)
    consume("radial_embedding.cutoff_fn.r_max",
            expect("r_max", cfg.cutoff, "radial cutoff r_max") if cfg is not None else None)

    for t, inter in enumerate(params["interactions"]):
        pre = f"interactions.{t}."
        h_ls_in = sorted(int(l) for l in inter["lin_up"])
        a_ls = tuple(sorted(int(l) for l in inter["lin_A"]))

        # linear_up: flat per-l (C, C) blocks, alpha = 1/sqrt(C)
        def up_tf(l_index, _h=tuple(h_ls_in)):
            def tf(a):
                return a.reshape(len(_h), C, C)[l_index] / np.sqrt(C)
            return tf
        for i, l in enumerate(h_ls_in):
            rules.append(Rule(pre + "linear_up.weight",
                              ("interactions", t, "lin_up", str(l), "w"), up_tf(i)))

        # radial MLP (e3nn FullyConnectedNet): fold 1/sqrt(fan_in), the
        # normalize2mom(silu) gain into post-activation layers and, on the
        # output layer, the per-path CG sign calibration (e3nn's wigner_3j
        # against real_clebsch_gordan's sign convention)
        n_layers = len(inter["radial"])
        path_signs = _path_signs(sd, inter, a_ls,
                                 paths=model.msg_paths[t] if model is not None else None)
        for li in range(n_layers):
            key = pre + f"conv_tp_weights.layer{li}.weight"
            g = (gain if li > 0 else 1.0)
            d_in = np.shape(inter["radial"][li]["w"])[0]
            if li == n_layers - 1 and path_signs is not None:
                def last_tf(a, _g=g, _d=d_in, _s=path_signs):
                    out = a * (_g / np.sqrt(_d))
                    return (out.reshape(_d, len(_s), C) * _s[None, :, None]).reshape(_d, -1)
                rules.append(Rule(key, ("interactions", t, "radial", li, "w"), last_tf))
            else:
                rules.append(Rule(key, ("interactions", t, "radial", li, "w"),
                                  _scaled(g / np.sqrt(d_in))))

        # post-conv_tp linear: per-path (C, C) blocks in instruction order
        # (sorted by output irrep, lin_A's path axis), alpha = 1/sqrt(P_l C)
        offsets = {}
        off = 0
        for l in a_ls:
            P_l = np.shape(inter["lin_A"][str(l)])[0]
            offsets[l] = (off, P_l)
            off += P_l
        n_paths_tot = off

        def lin_tf(l, _offsets=dict(offsets), _tot=n_paths_tot):
            o, P_l = _offsets[l]
            def tf(a):
                return a.reshape(_tot, C, C)[o:o + P_l] / np.sqrt(P_l * C)
            return tf
        for l in a_ls:
            rules.append(Rule(pre + "linear.weight", ("interactions", t, "lin_A", str(l)),
                              lin_tf(l)))

        # skip_tp (FullyConnectedTensorProduct with the species one-hot):
        # flat per-l (C, S, C) blocks, alpha = 1/sqrt(C S)
        res_ls = sorted(int(l) for l in inter["lin_res"])

        def res_tf(l_index, _n=len(res_ls)):
            def tf(a):
                return a.reshape(_n, C, S, C)[l_index].transpose(1, 0, 2) / np.sqrt(C * S)
            return tf
        for i, l in enumerate(res_ls):
            rules.append(Rule(pre + "skip_tp.weight", ("interactions", t, "lin_res", str(l)),
                              res_tf(i)))
        consume(pre + "avg_num_neighbors",
                expect("avg_num_neighbors", cfg.avg_num_neighbors, "avg_num_neighbors",
                       atol=1e-3) if cfg is not None else None)

        # products: symmetric-contraction weights with the exact U basis change
        ppre = f"products.{t}."
        out_ls = sorted(int(l) for l in inter["product"])
        S_A = sum(2 * l + 1 for l in a_ls)
        for i, l in enumerate(out_ls):
            cpre = ppre + f"symmetric_contractions.contractions.{i}."
            nus = sorted(int(k[1:]) for k in inter["product"][str(l)])
            numax = max(nus)

            def prod_tf(l=l, nu=None, _a=a_ls, _cpre=cpre):
                def tf(a):
                    U_ours = symmetric_coupling_basis(_a, l, nu)
                    u_flat = _find_u_buffer(sd, _cpre, S_A, nu)
                    if u_flat is None:
                        raise ValueError(
                            f"no U_matrix buffer found under {_cpre!r} for "
                            f"correlation {nu}; cannot basis-change the "
                            f"symmetric-contraction weights. Export the "
                            f"checkpoint with U buffers included.")
                    return np.einsum("pq,zqc->zpc", _basis_change(U_ours, u_flat), a)
                return tf

            rules.append(Rule(cpre + "weights_max",
                              ("interactions", t, "product", str(l), f"w{numax}"),
                              prod_tf(nu=numax)))
            # lower correlations, descending, only for orders the model has
            lower = [n for n in sorted(nus, reverse=True) if n != numax]
            for j, nu in enumerate(lower):
                rules.append(Rule(cpre + f"weights.{j}",
                                  ("interactions", t, "product", str(l), f"w{nu}"),
                                  prod_tf(nu=nu)))
            # the U buffers themselves are consumed (used via the transforms)
            for key in list(sd):
                if key.startswith(cpre) and ("U_matrix" in key or "U_tensors" in key):
                    consume(key)

        # product linear: per-l (C, C) blocks, alpha = 1/sqrt(C)
        def msg_tf(l_index, _n=len(out_ls)):
            def tf(a):
                return a.reshape(_n, C, C)[l_index] / np.sqrt(C)
            return tf
        for i, l in enumerate(out_ls):
            rules.append(Rule(ppre + "linear.weight",
                              ("interactions", t, "lin_msg", str(l), "w"), msg_tf(i)))

        # readouts
        rpre = f"readouts.{t}."
        if t == len(params["interactions"]) - 1:
            d_mid = np.shape(inter["readout"][0]["w"])[1]
            rules.append(Rule(rpre + "linear_1.weight", ("interactions", t, "readout", 0, "w"),
                              lambda a, _d=d_mid: a.reshape(C, _d) / np.sqrt(C)))
            rules.append(Rule(rpre + "linear_2.weight", ("interactions", t, "readout", 1, "w"),
                              lambda a, _d=d_mid: a.reshape(_d, H) * (gain / np.sqrt(_d))))
        else:
            rules.append(Rule(rpre + "linear.weight", ("interactions", t, "readout", 0, "w"),
                              lambda a: a.reshape(C, H) / np.sqrt(C)))

    rules.append(Rule("scale_shift.scale", ("scale",),
                      lambda a: np.broadcast_to(np.ravel(a), (H,)).copy()))
    rules.append(Rule("scale_shift.shift", ("shift",),
                      lambda a: np.broadcast_to(np.ravel(a), (H,)).copy()))

    # optional ZBL pair repulsion
    if "zbl" in params:
        rules.append(Rule("pair_repulsion_fn.a_exp", ("zbl", "a_exp"),
                          lambda a: a.reshape(())))
        rules.append(Rule("pair_repulsion_fn.a_prefactor", ("zbl", "a_prefactor"),
                          lambda a: a.reshape(())))
        # the ZBL evaluator hard-codes the universal screening coefficients,
        # the Cordero covalent-radii table, and ties the envelope power to
        # cfg.cutoff_p: check them instead of just consuming them
        from .pair import _ZBL_C, COVALENT_RADII

        consume("pair_repulsion_fn.c",
                expect("pair_repulsion_fn.c", _ZBL_C, "ZBL screening coefficients", atol=1e-6))
        consume("pair_repulsion_fn.p",
                expect("pair_repulsion_fn.p", float(cfg.cutoff_p),
                       "ZBL envelope power p (tied to cutoff_p)") if cfg is not None else None)

        def check_radii(a):
            got = np.ravel(np.asarray(a, dtype=np.float64))
            ours = COVALENT_RADII
            n = min(got.size, ours.size)
            # index 0 is the unused placeholder (ase uses 0.2 for 'X', the
            # table 0.0): compare real elements only
            close = np.isclose(got[1:n], ours[1:n], atol=2e-2)
            if not close.all():
                bad = int(np.argmax(~close)) + 1
                raise ValueError(
                    f"checkpoint covalent radii differ from the built-in "
                    f"Cordero table (first mismatch at Z={bad}: {got[bad]} vs "
                    f"{ours[bad]}); the ZBL cutoff would be wrong for those species")
            # species beyond the table cannot be validated, and the runtime
            # lookup would clamp them to its last entry
            if cfg is not None and cfg.atomic_numbers is not None:
                over = [z for z in cfg.atomic_numbers if z >= ours.size]
                if over:
                    raise ValueError(
                        f"ZBL covalent-radii table covers Z<={ours.size - 1}; model "
                        f"species {over} are outside it; extend COVALENT_RADII in "
                        f"models/pair.py")

        consume("pair_repulsion_fn.covalent_radii", check_radii)

    # remaining bookkeeping entries: e3nn output masks, CG sign calibration
    seen = {r.torch_name for r in rules}
    for key in sd:
        if key not in seen and (key.endswith("output_mask") or key.startswith("__cg_sign__")):
            consume(key)
    return rules


# ---------------------------------------------------------------------------
# CHGNet (matgl) mapping
# ---------------------------------------------------------------------------

def _torch_mlp_rules(sd: dict, prefix: str, path: tuple, seq: str = "layers") -> list[Rule]:
    """matgl ``MLP`` (an nn.ModuleList/Sequential ``seq`` of Linears
    interleaved with activation modules) -> a layer list. Linear indices are
    read from the state dict (activations carry no parameters)."""
    idxs = sorted({
        int(m.group(1)) for k in sd
        if (m := re.fullmatch(re.escape(prefix) + r"\." + seq + r"\.(\d+)\.weight", k))
    })
    if not idxs:
        raise KeyError(f"no Linear layers found under {prefix}.{seq}")
    rules = []
    for j, k in enumerate(idxs):
        rules.append(Rule(f"{prefix}.{seq}.{k}.weight", path + (j, "w"), lambda a: a.T))
        if f"{prefix}.{seq}.{k}.bias" in sd:
            rules.append(Rule(f"{prefix}.{seq}.{k}.bias", path + (j, "b")))
    return rules


def _torch_gated_mlp_rules(sd: dict, prefix: str, path: tuple) -> list[Rule]:
    """matgl ``GatedMLP`` (two nn.Sequentials: ``layers``, the core with
    silu, ``gates`` with sigmoid last) -> {'core': [...], 'gate': [...]}."""
    return (_torch_mlp_rules(sd, prefix, path + ("core",), seq="layers")
            + _torch_mlp_rules(sd, prefix, path + ("gate",), seq="gates"))


def _potential_extra_rules(sd: dict, species_ref_shape: tuple) -> list[Rule]:
    """matgl ``Potential.state_dict()`` extras, shared by the chgnet and
    tensornet maps: ``element_refs.property_offset`` -> species_ref,
    ``data_std`` -> data_std; a nonzero ``data_mean`` (a per-structure
    offset this per-atom parameterisation cannot carry exactly) is refused."""
    S = species_ref_shape[0]
    rules: list[Rule] = []
    if "element_refs.property_offset" in sd:
        rules.append(Rule("element_refs.property_offset", ("species_ref", "w"),
                          lambda a: np.reshape(a, (-1,))[:S].reshape(species_ref_shape)))
    if "data_std" in sd:
        rules.append(Rule("data_std", ("data_std",), lambda a: np.reshape(a, ())))
    if "data_mean" in sd:
        def expect_zero(a):
            if not np.allclose(np.asarray(a, dtype=np.float64), 0.0, atol=1e-12):
                raise ValueError(
                    f"data_mean = {np.ravel(a)} is nonzero: matgl applies it once "
                    f"per structure, which this per-atom parameterization cannot "
                    f"represent exactly; fold it into element_refs upstream or "
                    f"re-reference the checkpoint")
        rules.append(Rule("data_mean", None, expect_zero))
    return rules


@register_mapping("chgnet")
def chgnet_mapping(params, sd, model=None):
    """matgl ``CHGNet.state_dict()`` -> CHGNet params
    (``distmlip_tpu/models/convert.py:618-735``). Also takes a matgl
    ``Potential.state_dict()`` dump (``model.``-prefixed keys, with
    ``_potential_extra_rules``' extras)."""
    C = np.shape(params["atom_emb"]["w"])[1]
    S = np.shape(params["atom_emb"]["w"])[0]
    p = "model." if any(k.startswith("model.") for k in sd) else ""
    rules: list[Rule] = []

    # learnable basis frequencies (matgl RadialBessel/FourierExpansion)
    rules.append(Rule(p + "bond_expansion.frequencies", ("freq_bond",)))
    if "freq_three" in params and p + "threebody_bond_expansion.frequencies" in sd:
        rules.append(Rule(p + "threebody_bond_expansion.frequencies", ("freq_three",)))
        rules.append(Rule(p + "angle_expansion.frequencies", ("freq_angle",)))

    # embeddings: atom_embedding is nn.Embedding (its weight as is); a
    # one-hot single-layer MLP variant folds into the same table
    if p + "atom_embedding.weight" in sd:
        rules.append(Rule(p + "atom_embedding.weight", ("atom_emb", "w")))
    else:
        def onehot_fold(a):
            W = a.T  # (S, C)
            b = sd.get(p + "atom_embedding.layers.0.bias")
            if b is not None:
                W = W + np.asarray(_t(b))[None, :]
            return W
        rules.append(Rule(p + "atom_embedding.layers.0.weight", ("atom_emb", "w"), onehot_fold))
        if p + "atom_embedding.layers.0.bias" in sd:
            rules.append(Rule(p + "atom_embedding.layers.0.bias", None))
    rules += _torch_mlp_rules(sd, p + "bond_embedding", ("bond_emb",))
    if "freq_angle" in params and any(k.startswith(p + "angle_embedding.") for k in sd):
        rules += _torch_mlp_rules(sd, p + "angle_embedding", ("angle_emb",))

    # shared rbf message weights (bias-free linears)
    for tname, ours in (("atom_bond_weights", "atom_bond_w"),
                        ("bond_bond_weights", "bond_bond_w"),
                        ("threebody_bond_weights", "three_bond_w")):
        if p + f"{tname}.weight" in sd:
            if ours not in params:
                raise ValueError(
                    f"checkpoint has {tname} but the model config disables it "
                    f"(shared_bond_weights); rebuild with a matching config")
            rules.append(Rule(p + f"{tname}.weight", (ours, "w"), lambda a: a.T))

    def conv_rules(tpre, bpath, blk):
        out = _torch_gated_mlp_rules(sd, tpre + "node_update_func", bpath + ("node_update",))
        if tpre + "node_out_func.weight" in sd:
            out.append(Rule(tpre + "node_out_func.weight", bpath + ("node_out", "w"),
                            lambda a: a.T))
        else:
            # upstream variant without the out linear: the identity, in the
            # leaf's dtype so float64 parameters stay float64
            blk["node_out"]["w"] = np.eye(C, dtype=np.asarray(blk["node_out"]["w"]).dtype)
        return out

    # atom graph blocks
    for i, blk in enumerate(params["atom_blocks"]):
        tpre = p + f"atom_graph_layers.{i}.conv_layer."
        rules += conv_rules(tpre, ("atom_blocks", i), blk)
        has_eu = any(k.startswith(tpre + "edge_update_func.") for k in sd)
        if has_eu != ("edge_update" in blk):
            raise ValueError(
                f"atom_graph_layers.{i} edge update presence mismatch (checkpoint "
                f"{has_eu} vs config bond_update_hidden); rebuild with a matching config")
        if has_eu:
            rules += _torch_gated_mlp_rules(sd, tpre + "edge_update_func",
                                            ("atom_blocks", i, "edge_update"))
            if tpre + "edge_out_func.weight" in sd:
                rules.append(Rule(tpre + "edge_out_func.weight",
                                  ("atom_blocks", i, "edge_out", "w"), lambda a: a.T))
            else:
                blk["edge_out"]["w"] = np.eye(C, dtype=np.asarray(blk["edge_out"]["w"]).dtype)

    # bond graph blocks (line-graph conv + angle update)
    for i, blk in enumerate(params["bond_blocks"]):
        tpre = p + f"bond_graph_layers.{i}.conv_layer."
        rules += conv_rules(tpre, ("bond_blocks", i), blk)
        if any(k.startswith(tpre + "edge_update_func.") for k in sd):
            rules += _torch_gated_mlp_rules(sd, tpre + "edge_update_func",
                                            ("bond_blocks", i, "angle_update"))
        else:
            # no angle update in the checkpoint: zero ours (a residual no-op)
            blk["angle_update"] = zeros_like_tree(blk["angle_update"])

    # readouts
    if p + "sitewise_readout.weight" in sd:
        rules += linear_rule(p + "sitewise_readout", ("sitewise",),
                             bias=p + "sitewise_readout.bias" in sd)
    if any(k.startswith(p + "final_layer.gates.") for k in sd):
        raise ValueError(
            "checkpoint final_layer is a GatedMLP (final_mlp_type='gated'); "
            "only the MLP readout is supported")
    rules += _torch_mlp_rules(sd, p + "final_layer", ("final",))

    if p:
        rules += _potential_extra_rules(sd, (S, 1))
    return rules


# ---------------------------------------------------------------------------
# TensorNet (matgl / torchmd-net) mapping
# ---------------------------------------------------------------------------

def _ln_rules(prefix: str, path: tuple) -> list[Rule]:
    """nn.LayerNorm -> {'g', 'b'}."""
    return [Rule(f"{prefix}.weight", path + ("g",)), Rule(f"{prefix}.bias", path + ("b",))]


@register_mapping("tensornet")
def tensornet_mapping(params, sd, model=None):
    """matgl ``TensorNet.state_dict()`` -> TensorNet params
    (``distmlip_tpu/models/convert.py:748-816``). Takes matgl
    ``Potential.state_dict()`` dumps as the CHGNet map does."""
    p = "model." if any(k.startswith("model.") for k in sd) else ""
    S = np.shape(params["species_emb"]["w"])[0]
    rules: list[Rule] = []
    tpre = p + "tensor_embedding."

    rules.append(Rule(tpre + "emb.weight", ("species_emb", "w")))
    rules += linear_rule(tpre + "emb2", ("emb2",), bias=tpre + "emb2.bias" in sd)
    for i in range(3):
        pre = tpre + f"distance_proj{i + 1}"
        rules += linear_rule(pre, ("dist_proj", i), bias=pre + ".bias" in sd)
    for i in range(2):
        pre = tpre + f"linears_scalar.{i}"
        rules += linear_rule(pre, ("emb_lin_scalar", i), bias=pre + ".bias" in sd)
    for i in range(3):
        rules.append(Rule(tpre + f"linears_tensor.{i}.weight", ("emb_lin_tensor", i, "w"),
                          lambda a: a.T))
    rules += _ln_rules(tpre + "init_norm", ("init_norm",))

    for t, _ in enumerate(params["layers"]):
        lpre = p + f"layers.{t}."
        for i in range(3):
            pre = lpre + f"linears_scalar.{i}"
            rules += linear_rule(pre, ("layers", t, "lin_scalar", i), bias=pre + ".bias" in sd)
        for i in range(6):
            rules.append(Rule(lpre + f"linears_tensor.{i}.weight",
                              ("layers", t, "lin_tensor", i, "w"), lambda a: a.T))

    rules += _ln_rules(p + "out_norm", ("out_norm",))
    rules += linear_rule(p + "linear", ("linear",), bias=p + "linear.bias" in sd)
    rules += _torch_mlp_rules(sd, p + "final_layer.gated", ("final",))

    # radial-basis buffers: the model's basis is the fixed n*pi bessel set,
    # so trained or non-bessel frequencies are refused, not consumed
    cfg = model.cfg if model is not None else None
    for key in list(sd):
        tail = key[len(p):] if key.startswith(p) else key
        if tail.startswith("bond_expansion."):
            if "frequenc" in tail and cfg is not None:
                def check_freq(a, _n=cfg.num_rbf):
                    got = np.ravel(np.asarray(a, dtype=np.float64))
                    want = np.pi * np.arange(1, _n + 1)
                    if got.size != want.size or not np.allclose(got, want, atol=1e-4):
                        raise ValueError(
                            "checkpoint bond_expansion frequencies differ from the "
                            "fixed n*pi bessel basis; trained frequencies are not "
                            "representable")
                rules.append(Rule(key, None, check_freq))
            else:
                rules.append(Rule(key, None))

    if p:
        rules += _potential_extra_rules(sd, (S, 1))
    return rules


# ---------------------------------------------------------------------------
# eSCN / UMA (fairchem eSCNMDBackbone) mapping
# ---------------------------------------------------------------------------

def _rad_rules(prefix: str, path: tuple) -> list[Rule]:
    """RadialFunction (Linear -> LayerNorm -> SiLU -> Linear) under
    fairchem's Sequential numbering: net.0 Linear, net.1 LayerNorm, net.3
    the last Linear. ESCNMD keeps torch's (out, in) layout: no transpose."""
    return [
        Rule(f"{prefix}.net.0.weight", path + ("lins", 0, "w")),
        Rule(f"{prefix}.net.0.bias", path + ("lins", 0, "b")),
        Rule(f"{prefix}.net.1.weight", path + ("lns", 0, "g")),
        Rule(f"{prefix}.net.1.bias", path + ("lns", 0, "b")),
        Rule(f"{prefix}.net.3.weight", path + ("lins", 1, "w")),
        Rule(f"{prefix}.net.3.bias", path + ("lins", 1, "b")),
    ]


def _so2_rules(prefix: str, path: tuple, m_max: int, internal: bool) -> list[Rule]:
    """SO2_Convolution: fc_m0 (+ bias) and the per-|m| so2_m_conv.{m-1}.fc
    weights (bias-free complex pairs, output = [real | imag] halves). MOLE
    checkpoints carry the same names with a leading expert axis, which
    ``set_in`` checks against the leaf. ``internal`` marks fairchem's
    internal_weights=True convolutions (no rad_func)."""
    rules = [Rule(f"{prefix}.fc_m0.weight", path + ("m0",)),
             Rule(f"{prefix}.fc_m0.bias", path + ("m0_b",))]
    for m in range(1, m_max + 1):
        rules.append(Rule(f"{prefix}.so2_m_conv.{m - 1}.fc.weight", path + (f"m{m}",)))
    if not internal:
        rules += _rad_rules(f"{prefix}.rad_func", path + ("rad",))
    return rules


@register_mapping("escn")
def escn_mapping(params, sd, model=None):
    """fairchem ``eSCNMDBackbone.state_dict()`` -> ESCNMD params
    (``distmlip_tpu/models/convert.py:858-976``). A ``backbone.`` prefix
    (whole-model UMA dumps) is handled; head tensors map onto the energy
    head when present.

    Not populated from any checkpoint: ``species_ref`` (per-element
    reference energies) and ``mole_gate`` (the expert-routing MLP: this
    model routes on the owned atoms' composition and the csd vector, an
    input space other than fairchem's routing net). A checkpoint carrying
    MOLE-routing tensors is refused, even when not strict, rather than
    converted into a model whose expert mixtures would be silently random.
    """
    # "mole" as a standalone token (mole_coefficients, blocks.0.mole.net...)
    # or any "routing"; not substrings of names such as molecule_embedding.
    # Expert WEIGHTS (a leading expert axis on so2 tensors) convert.
    mole_keys = [k for k in sd
                 if re.search(r"(?<![a-zA-Z])mole(?![a-zA-Z])", k, re.IGNORECASE)
                 or "routing" in k.lower()]
    if mole_keys:
        raise ValueError(
            f"state dict carries {len(mole_keys)} MOLE expert-routing tensors "
            f"(first 5: {mole_keys[:5]}) which have no equivalent here: this "
            "framework's expert gate (params['mole_gate']) routes on system "
            "composition + csd and must be retrained. Remove the routing "
            "tensors from the dict to convert the expert weights themselves; "
            "the resulting gate is fresh-initialized, NOT the upstream routing.")
    p = "backbone." if any(k.startswith("backbone.") for k in sd) else ""
    cfg = model.cfg if model is not None else None
    n_blocks = len(params["blocks"])
    # ESCNMD clamps m_max = min(mmax, lmax) (CoeffLayout); the rules match
    m_max = (min(cfg.mmax, cfg.lmax) if cfg is not None
             else len([k for k in sd if f"{p}blocks.0.so2_conv_1.so2_m_conv." in k
                       and k.endswith(".fc.weight")]))

    rules: list[Rule] = [
        Rule(p + "sphere_embedding.weight", ("sphere_embedding", "w")),
        Rule(p + "source_embedding.weight", ("source_embedding", "w")),
        Rule(p + "target_embedding.weight", ("target_embedding", "w")),
        Rule(p + "csd_embedding.charge_embedding.weight", ("csd", "charge", "w")),
        Rule(p + "csd_embedding.spin_embedding.weight", ("csd", "spin", "w")),
        Rule(p + "csd_embedding.dataset_embedding.weight", ("csd", "dataset", "w")),
        Rule(p + "csd_embedding.mix_csd.weight", ("csd", "mix", "w")),
        Rule(p + "csd_embedding.mix_csd.bias", ("csd", "mix", "b")),
        Rule(p + "norm.affine_weight", ("norm", "w")),
    ]
    rules += _rad_rules(p + "edge_degree_embedding.rad_func", ("edge_deg_rad",))

    # distance_expansion: a gaussian-offset buffer, checked against the
    # linspace(0, cutoff, num_distance_basis) the model builds
    if p + "distance_expansion.offset" in sd and cfg is not None:
        def check_offsets(a, _cfg=cfg):
            want = np.linspace(0.0, _cfg.cutoff, _cfg.num_distance_basis)
            got = np.ravel(np.asarray(a, dtype=np.float64))
            if got.size != want.size or not np.allclose(got, want, atol=1e-5):
                raise ValueError(
                    "checkpoint gaussian offsets differ from "
                    "linspace(0, cutoff, num_distance_basis)")
        rules.append(Rule(p + "distance_expansion.offset", None, check_offsets))

    for i in range(n_blocks):
        bp = f"{p}blocks.{i}."
        path = ("blocks", i)
        rules.append(Rule(bp + "norm_1.affine_weight", path + ("norm1", "w")))
        rules += _so2_rules(bp + "so2_conv_1", path + ("so2_1",), m_max, internal=False)
        rules += _so2_rules(bp + "so2_conv_2", path + ("so2_2",), m_max, internal=True)
        rules.append(Rule(bp + "ff_norm.affine_weight", path + ("ff_norm", "w")))
        for name, leaf in (("so3_linear_1", "lin1"), ("gating_linear", "gate"),
                           ("so3_linear_2", "lin2")):
            rules.append(Rule(bp + f"ff.{name}.weight", path + ("ff", leaf, "w")))
            rules.append(Rule(bp + f"ff.{name}.bias", path + ("ff", leaf, "b")))

    # energy head (fairchem heads are separate modules; a whole-model dump
    # carries them as heads.energy.*)
    for hp in ("heads.energy.mlp.", "energy_head.mlp."):
        if any(k.startswith(hp) for k in sd):
            rules += [
                Rule(hp + "0.weight", ("energy_head", "lin1", "w")),
                Rule(hp + "0.bias", ("energy_head", "lin1", "b")),
                Rule(hp + "2.weight", ("energy_head", "lin2", "w")),
                Rule(hp + "2.bias", ("energy_head", "lin2", "b")),
            ]
            break
    return rules


def from_torch(arch: str, state_dict, params, strict: bool = True, model=None):
    """Map an upstream torch ``state_dict`` onto the port's ``params``.

    ``state_dict``: a mapping of names to torch tensors or numpy arrays (a
    live module's ``state_dict()``, or ``np.load`` of a
    ``tools/export_upstream.py`` npz). ``params``: a parameter tree of the
    target model (its ``init``), whose leaves give every converted tensor's
    shape and dtype; it is not modified. Returns ``(params, report)``: a new
    tree of torch tensors on ``params``' device, and ``{"mapped": n,
    "unused_torch": [names]}``. Pass ``model`` (the model instance) to
    validate checkpoint constants (cutoff, envelope power, bessel
    frequencies, avg_num_neighbors, gaussian offsets) against its config
    and to resolve MACE's CG sign calibration unambiguously. ``strict``
    fails loudly on any missing or unmapped tensor.
    """
    if arch not in MAPPINGS:
        raise KeyError(f"no mapping registered for {arch!r}; have {sorted(MAPPINGS)}")
    sd = dict(state_dict)
    tree = _numpy_tree(params)
    rules = MAPPINGS[arch](tree, sd, model)
    tree, report = convert(sd, tree, rules, strict=strict)
    return params_from_numpy(tree, _tree_device(params) or "cpu"), report
