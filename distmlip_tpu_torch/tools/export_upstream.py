"""Read an upstream torch checkpoint into a state dict, or export it as an
npz, for the port's ``models/convert.py`` ``from_torch``.

Port of ``distmlip_tpu/tools/export_upstream.py``. The port is torch, so a
checkpoint needs no npz on the way in:

    from distmlip_tpu_torch.tools.export_upstream import load_state_dict
    from distmlip_tpu_torch.models.convert import from_torch

    sd = load_state_dict("uma.pt")                       # fairchem / matgl
    params, report = from_torch("escn", sd, model.init(0), model=model)

An npz export is for moving weights to a machine without the upstream
package:

    python -m distmlip_tpu_torch.tools.export_upstream escn uma.pt out.npz
    sd = dict(np.load("out.npz"))

``load_state_dict`` and ``export_state_dict`` (matgl CHGNet/TensorNet and
fairchem eSCN/UMA) need plain torch for state-dict checkpoints; a pickled
module needs its package importable to unpickle. ``export_mace`` needs
mace-torch and e3nn: it exports every tensor and buffer of a live
``ScaleShiftMACE`` (the symmetric-contraction U matrices ride along as
buffers, which is what makes the exact product-basis change possible) plus
a CG sign calibration: e3nn's wigner_3j and the port's
``real_clebsch_gordan`` agree up to a per-(l1, l2, l3) sign, recorded as
``__cg_sign__.{l1}.{l2}.{l3}`` entries that the mace map folds into the
radial-MLP output blocks.
"""

from __future__ import annotations

import sys

import numpy as np


def _cg_signs(l_max: int = 3) -> dict:
    """Per-(l1, l2, l3) sign s with real_clebsch_gordan = s sqrt(2 l3 + 1) w3j
    (needs e3nn)."""
    from e3nn import o3

    from ..ops.so3 import real_clebsch_gordan

    out = {}
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                if (l1 + l2 + l3) % 2:
                    continue
                ours = real_clebsch_gordan(l1, l2, l3)
                scaled = np.sqrt(2 * l3 + 1) * o3.wigner_3j(l1, l2, l3).numpy()
                dot = float(np.sum(ours * scaled))
                norm = float(np.sqrt(np.sum(ours**2) * np.sum(scaled**2)))
                align = dot / max(norm, 1e-12)
                if abs(abs(align) - 1.0) > 1e-4:
                    # a +-1 calibration cannot represent this; exporting one
                    # anyway would give a silently wrong potential
                    raise RuntimeError(
                        f"CG ({l1},{l2},{l3}) bases differ beyond a sign "
                        f"(|cos|={abs(align):.6f}); conversion needs a full per-path "
                        f"basis alignment")
                out[f"__cg_sign__.{l1}.{l2}.{l3}"] = np.array(1.0 if align >= 0 else -1.0)
    return out


def export_mace(model_path: str, out_path: str) -> None:
    """A mace-torch model file -> npz with the CG sign calibration (needs
    mace-torch and e3nn importable)."""
    import torch

    model = torch.load(model_path, map_location="cpu", weights_only=False)
    if hasattr(model, "models"):  # mace calculators wrap a list
        model = model.models[0]
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    sd.update(_cg_signs(int(getattr(model, "max_ell", 3))))
    np.savez_compressed(out_path, **sd)
    print(f"exported {len(sd)} tensors -> {out_path}")


def load_state_dict(model_path: str) -> dict:
    """A matgl (chgnet/tensornet) or fairchem (escn/UMA) checkpoint -> a
    dict of CPU torch tensors, ready for ``from_torch``.

    A dict checkpoint (fairchem: ``{"state_dict": ...}`` or a raw state
    dict) loads with plain torch; a leading ``module.`` (DDP) is stripped.
    A pickled module (matgl ``Potential``) exports whole: the maps accept
    its ``model.`` prefix, and data_mean / data_std / element_refs ride
    along. The maps handle the prefixes as they are (``model.`` for matgl
    Potential dumps, ``backbone.`` for whole-model UMA dumps)."""
    import torch

    obj = torch.load(model_path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        sd = obj.get("state_dict", obj)
        sd = {k: v for k, v in sd.items() if hasattr(v, "detach")}
        sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    else:
        sd = obj.state_dict()
    return {k: v.detach().cpu() for k, v in sd.items()}


def export_state_dict(model_path: str, out_path: str) -> None:
    """``load_state_dict`` written as an npz; dtypes numpy lacks (bf16)
    upcast to float32."""
    import torch

    numpy_ok = (torch.float32, torch.float64, torch.int32, torch.int64, torch.bool,
                torch.int8, torch.uint8, torch.int16)
    out = {k: (v.numpy() if v.dtype in numpy_ok else v.float().numpy())
           for k, v in load_state_dict(model_path).items()}
    np.savez_compressed(out_path, **out)
    print(f"exported {len(out)} tensors -> {out_path}")


_EXPORTERS = {
    "mace": export_mace,
    "chgnet": export_state_dict,
    "tensornet": export_state_dict,
    "escn": export_state_dict,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3 or argv[0] not in _EXPORTERS:
        print(__doc__)
        print("usage: python -m distmlip_tpu_torch.tools.export_upstream "
              f"{{{'|'.join(sorted(_EXPORTERS))}}} <model.pt> <out.npz>")
        return 2
    _EXPORTERS[argv[0]](argv[1], argv[2])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
