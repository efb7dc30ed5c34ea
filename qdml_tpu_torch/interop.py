"""Carry weights from the JAX package into the port (``qdml_tpu/train/torch_interop.py:87-295``).

Each function takes Flax variable trees as nested dicts of numpy arrays (as
``jax.device_get`` returns them; no JAX is imported here) and returns the
port's state dict, in reference naming, as CPU tensors. The layout changes
are the JAX package's own: conv kernels transpose (kh, kw, I, O) -> (O, I,
kh, kw), and every Linear that reads a flattened conv map has its input axis
permuted, because NHWC flattens (H, W, C) H-major while torch flattens
(C, H, W) C-major.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_TRUNK_BLOCKS = (0, 3, 6)  # cnn.{0,3,6} convs, cnn.{1,4,7} BatchNorms
_SC_HW = (4, 2)  # feature map after two maxpools of (16, 8)


def _flat_perm(h: int, w: int, c: int) -> np.ndarray:
    """perm[k_nhwc] = k_torch for a flattened (C,H,W)->(H,W,C) feature map."""
    k = np.arange(h * w * c)
    hh = k // (w * c)
    ww = (k // c) % w
    cc = k % c
    return cc * (h * w) + hh * w + ww


def _kernel_to_linear(kernel, perm: np.ndarray | None) -> np.ndarray:
    """Flax Dense kernel (in, out) -> torch Linear weight (out, in), undoing
    the input-axis permutation of a flattened conv map."""
    w = np.asarray(kernel)
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        w = w[inv]
    return w.T.copy()


def _conv_to_torch(kernel) -> np.ndarray:
    return np.transpose(np.asarray(kernel), (3, 2, 0, 1)).copy()


def _copy(x) -> np.ndarray:
    return np.array(x, copy=True)


def _as_tensors(sd: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True, order="C")) for k, v in sd.items()}


def hdce_state_dict_from_flax(
    variables: Mapping[str, Any], image_hw: tuple[int, int] = (16, 8)
) -> dict[str, torch.Tensor]:
    """Flax ``HDCE`` variables (``params`` + ``batch_stats``) -> the port's
    :class:`~qdml_tpu_torch.train.hdce.HDCE` state dict."""
    params = variables["params"]["StackedConvP128_0"]["VmapConvP128_0"]
    stats = variables["batch_stats"]["StackedConvP128_0"]["VmapConvP128_0"]
    kernel0 = np.asarray(params["ConvBlock_0"]["Conv_0"]["kernel"])
    n_scen, features = kernel0.shape[0], kernel0.shape[-1]
    sd: dict[str, np.ndarray] = {}
    for s in range(n_scen):
        for i, idx in enumerate(_TRUNK_BLOCKS):
            p, st = params[f"ConvBlock_{i}"], stats[f"ConvBlock_{i}"]
            pre = f"trunks.{s}.cnn."
            sd[f"{pre}{idx}.weight"] = _conv_to_torch(np.asarray(p["Conv_0"]["kernel"])[s])
            sd[f"{pre}{idx + 1}.weight"] = _copy(np.asarray(p["BatchNorm_0"]["scale"])[s])
            sd[f"{pre}{idx + 1}.bias"] = _copy(np.asarray(p["BatchNorm_0"]["bias"])[s])
            sd[f"{pre}{idx + 1}.running_mean"] = _copy(np.asarray(st["BatchNorm_0"]["mean"])[s])
            sd[f"{pre}{idx + 1}.running_var"] = _copy(np.asarray(st["BatchNorm_0"]["var"])[s])
            sd[f"{pre}{idx + 1}.num_batches_tracked"] = np.asarray(0, np.int64)
    dense = variables["params"]["FCP128_0"]["Dense_0"]
    sd["head.FC.weight"] = _kernel_to_linear(dense["kernel"], _flat_perm(*image_hw, features))
    sd["head.FC.bias"] = _copy(dense["bias"])
    return _as_tensors(sd)


def sc_state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``SCP128`` params -> the port's ``SCP128`` state dict."""
    return _as_tensors({
        "conv1.weight": _conv_to_torch(params["Conv_0"]["kernel"]),
        "conv2.weight": _conv_to_torch(params["Conv_1"]["kernel"]),
        "FC.weight": _kernel_to_linear(params["Dense_0"]["kernel"], _flat_perm(*_SC_HW, 32)),
        "FC.bias": _copy(params["Dense_0"]["bias"]),
    })


def qsc_state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``QSCP128`` params -> the port's ``QSCP128`` state dict."""
    pre = params["QSCPreprocess_0"]
    return _as_tensors({
        "preprocess.0.weight": _conv_to_torch(pre["Conv_0"]["kernel"]),
        "preprocess.0.bias": _copy(pre["Conv_0"]["bias"]),
        "preprocess.3.weight": _conv_to_torch(pre["Conv_1"]["kernel"]),
        "preprocess.3.bias": _copy(pre["Conv_1"]["bias"]),
        "preprocess.7.weight": _kernel_to_linear(
            pre["Dense_0"]["kernel"], _flat_perm(*_SC_HW, 32)
        ),
        "preprocess.7.bias": _copy(pre["Dense_0"]["bias"]),
        "qlayer.weights": _copy(params["qweights"]),
        "classifier.weight": np.asarray(params["Dense_0"]["kernel"]).T.copy(),
        "classifier.bias": _copy(params["Dense_0"]["bias"]),
    })
