"""The launch plans of TensorNet's bf16 kernels, on the CPU: what of them
runs here.

``kernels.tensornet_embed_bf16_plan``, ``tensornet_interaction_bf16_plan``
and ``tensornet_interaction_backward_bf16_plan`` read the route a bf16
launch of ``csrc/edge_aggregate.cu`` takes (channels a lane, warps, edges
in flight, registers) from the kernel library itself. Here: each refuses
tensors that are not bf16 on a card before it loads the library, the two
forwards' plans are exported by ``distmlip_tpu_torch.kernels``, and a
forward's plan hands the library its arrays' addresses, a null output (a
fresh allocation), the dst rows and C, and reads back what the library
writes. The routes themselves run only on a card
(``tests/test_torch_cuda.py``).
"""

import ctypes
import types
from unittest import mock

import numpy as np
import pytest
import torch

from distmlip_tpu_torch import kernels as K
from distmlip_tpu_torch.kernels import build, edge_aggregate
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _arrays(which, c=64, e=40, n_node=7):
    rng = np.random.default_rng(c)
    shapes = ([(e, c)] * 4 if which == "embed"
              else [(e, c, 3), (n_node, c), (n_node, 3, c), (n_node, 6, c)])
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16() for s in shapes]


def _plan_call(which, arrays):
    if which == "embed":
        return K.tensornet_embed_bf16_plan(*arrays, 5)
    if which == "interaction":
        return K.tensornet_interaction_bf16_plan(*arrays, 5)
    g = torch.zeros((5, 3, 3, arrays[0].shape[1]), dtype=arrays[0].dtype)
    return K.tensornet_interaction_backward_bf16_plan(g, *arrays)


def _no_library(name):
    raise AssertionError(f"the kernel library {name!r} was loaded")


@pytest.mark.parametrize("which", ["embed", "interaction", "backward"])
def test_plans_refuse_cpu_tensors_before_loading_the_library(which):
    """bf16 tensors on the CPU: ValueError, and the library never loads."""
    arrays = _arrays("embed" if which == "embed" else "interaction")
    with mock.patch.object(build, "load", _no_library), \
            pytest.raises(ValueError, match="bf16 CUDA tensors"):
        _plan_call(which, arrays)


@pytest.mark.parametrize("which", ["embed", "interaction", "backward"])
def test_plans_refuse_float32_before_loading_the_library(which):
    """float32 tensors that report a card: ValueError (the plans are the
    bf16 kernels'), and the library never loads."""
    arrays = [x.float() for x in _arrays("embed" if which == "embed" else "interaction")]
    with mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                           return_value=True), \
            mock.patch.object(build, "load", _no_library), \
            pytest.raises(ValueError, match="bf16 CUDA tensors"):
        _plan_call(which, arrays)


def test_forward_plans_are_exported():
    assert K.tensornet_embed_bf16_plan is edge_aggregate.tensornet_embed_bf16_plan
    assert K.tensornet_interaction_bf16_plan is edge_aggregate.tensornet_interaction_bf16_plan


@pytest.mark.parametrize("lanes,path", [(2, "channel pairs"), (1, "single channels")])
@pytest.mark.parametrize("which", ["embed", "interaction"])
def test_forward_plan_reads_the_library_route(which, lanes, path):
    """A stand-in library records the call and writes a plan: the wrapper
    passes the four arrays' addresses, a null output, the dst rows and C,
    and returns every field the library wrote under its name, with the
    path the channels a lane name."""
    arrays = _arrays(which, c=30)
    symbol = f"distmlip_tensornet_{which}_bf16_plan"
    calls = []

    def plan_fn(*args):
        calls.append(args[:-1])
        out = args[-1]
        for k, v in enumerate((lanes, 32 * lanes, 1, 4, 32, 8, 80, 9, 20480)):
            out[k] = v
        return 0

    library = types.SimpleNamespace(**{symbol: plan_fn})
    with mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                           return_value=True), \
            mock.patch.object(build, "load", lambda name: library):
        got = _plan_call(which, arrays)
    assert calls == [tuple(x.data_ptr() for x in arrays) + (None, 5, 30)]
    assert got == {"channels_a_lane": lanes, "channels_a_warp": 32 * lanes, "warps_a_row": 1,
                   "edges_in_flight": 4, "indices_a_turn": 32, "warps_a_block": 8,
                   "registers": 80, "blocks": 9, "shared_bytes": 20480, "path": path}
    assert plan_fn.argtypes == [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                                        ctypes.c_void_p]


@pytest.mark.parametrize("which", ["embed", "interaction"])
def test_forward_plan_raises_on_a_library_error(which):
    """A cudaError_t from the library raises with its code."""
    library = types.SimpleNamespace(
        **{f"distmlip_tensornet_{which}_bf16_plan": lambda *args: 9})
    with mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                           return_value=True), \
            mock.patch.object(build, "load", lambda name: library), \
            pytest.raises(RuntimeError, match="cudaError_t 9"):
        _plan_call(which, _arrays(which))
