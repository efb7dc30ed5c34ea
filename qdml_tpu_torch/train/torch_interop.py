"""Reference (PyTorch) checkpoints: import and export ``.pth`` state dicts
(``qdml_tpu/train/torch_interop.py``).

A user of the reference repo has checkpoints saved by ``torch.save`` under
filename-encoded names (``Runner_P128_QuantumNAT_onchipQNN.py:237-266,
417-426``) in one of three dict formats, possibly with DataParallel
``module.`` prefixes (the loader quirks of ``Test.py:23-62``). The port's
modules already carry the reference's parameter names (``cnn.*``, ``FC.*``,
``conv1``/``conv2``, ``preprocess.*``, ``qlayer.weights``, ``classifier.*``),
so where the JAX package converts layouts this module only unwraps a file,
strips the prefix, and splits or stacks HDCE's three trunks
(``trunks.{s}.cnn.*``) and shared head (``head.FC.*``) against the
reference's ``Conv{0,1,2}`` and ``Linear`` files. The files are read with
``torch.load(weights_only=True)``: tensors and plain containers only, no
arbitrary unpickling of a foreign file.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

# ---------------------------------------------------------------------------
# State-dict normalisation (the Test.py:23-62 quirks)
# ---------------------------------------------------------------------------


def normalize_state_dict(obj: Any, fallback_key: str | None = None) -> dict[str, torch.Tensor]:
    """Accept the three reference checkpoint formats and strip ``module.``
    (``qdml_tpu/train/torch_interop.py:38-59``): ``{fallback_key: sd}``,
    ``{'state_dict': sd}`` or a raw state dict; values are torch tensors or
    numpy arrays, returned as CPU tensors. A BatchNorm's one-element
    ``num_batches_tracked`` is read as the 0-d count torch keeps (the JAX
    package's writer stores it with shape (1,): ``np.ascontiguousarray``
    of a 0-d array is 1-d)."""
    sd = obj
    if isinstance(obj, Mapping):
        if fallback_key is not None and isinstance(obj.get(fallback_key), Mapping):
            sd = obj[fallback_key]
        elif isinstance(obj.get("state_dict"), Mapping):
            sd = obj["state_dict"]
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if k.endswith("num_batches_tracked") and t.numel() == 1:
            t = t.reshape(())
        out[k] = t
    return out


def load_pth(path: str, fallback_key: str | None = None) -> dict[str, torch.Tensor]:
    """Load a reference checkpoint file and normalise it."""
    return normalize_state_dict(torch.load(path, map_location="cpu", weights_only=True), fallback_key)


def save_pth(path: str, sd: Mapping[str, torch.Tensor], wrap_key: str | None = None) -> None:
    """Save a state dict as a reference-loadable ``.pth`` (CPU tensors),
    optionally wrapped as ``{wrap_key: sd}``, as the reference wraps its HDCE
    parts (``Runner...py:237-264``)."""
    obj: dict = {k: v.detach().cpu().contiguous() for k, v in sd.items()}
    if wrap_key is not None:
        obj = {wrap_key: obj}
    torch.save(obj, path)


# ---------------------------------------------------------------------------
# HDCE: three Conv_P128 state dicts + one FC_P128 state dict <-> the port's HDCE
# ---------------------------------------------------------------------------


def hdce_from_reference(
    conv_sds: list[Mapping[str, torch.Tensor]], fc_sd: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """The reference's per-scenario ``Conv{s}`` dicts and the shared
    ``Linear`` dict -> the port's :class:`~qdml_tpu_torch.train.hdce.HDCE`
    state dict. A trunk saved without ``num_batches_tracked`` gets 0, as the
    JAX package's export writes it."""
    sd: dict[str, torch.Tensor] = {}
    for s, conv in enumerate(conv_sds):
        for k, v in conv.items():
            sd[f"trunks.{s}.{k}"] = v
        for k in conv:
            if k.endswith(".running_mean"):
                nbt = k[: -len("running_mean")] + "num_batches_tracked"
                sd.setdefault(f"trunks.{s}.{nbt}", torch.tensor(0, dtype=torch.int64))
    for k, v in fc_sd.items():
        sd[f"head.{k}"] = v
    return sd


def hdce_to_reference(
    sd: Mapping[str, torch.Tensor],
) -> tuple[list[dict[str, torch.Tensor]], dict[str, torch.Tensor]]:
    """Inverse of :func:`hdce_from_reference`: the port's HDCE state dict ->
    (one ``Conv_P128`` dict per scenario, the ``FC_P128`` dict)."""
    convs: dict[int, dict[str, torch.Tensor]] = {}
    fc: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith("trunks."):
            s, rest = k[len("trunks."):].split(".", 1)
            convs.setdefault(int(s), {})[rest] = v
        elif k.startswith("head."):
            fc[k[len("head."):]] = v
        else:
            raise KeyError(f"unexpected HDCE state-dict key {k!r}")
    return [convs[s] for s in sorted(convs)], fc


# ---------------------------------------------------------------------------
# Reference checkpoint-file naming + directory import/export
# ---------------------------------------------------------------------------


def reference_ckpt_name(role: str, batch_size: int, snr_db: int, tag: str) -> str:
    """Filename-encoded reference checkpoint scheme (``Runner...py:237-266,
    417-426``): role in {Conv0, Conv1, Conv2, Linear, QSC_OPT}; tag 'best' or
    'epochN'. The SC classifier's pattern is :func:`reference_sc_ckpt_name`."""
    return f"{role}_{batch_size}_{snr_db}dB_{tag}_DML.pth"


def reference_sc_ckpt_name(batch_size: int, snr_db: int, tag: str) -> str:
    """Reference SC classifier filename ``{bs}_{snr}dB_{tag}_DML_SC.pth``
    (``Test.py:71-72`` loads ``..._epoch99_DML_SC.pth`` with key 'cnn')."""
    return f"{batch_size}_{snr_db}dB_{tag}_DML_SC.pth"


def import_reference_dir(
    src_dir: str, batch_size: int = 256, snr_db: int = 10, tag: str = "best"
) -> dict[str, dict[str, torch.Tensor]]:
    """Every reference checkpoint present in ``src_dir`` as the port's state
    dicts: any of ``"hdce"`` (:class:`HDCE`), ``"sc"`` (``SCP128``) and
    ``"qsc"`` (``QSCP128``); missing files are skipped, as the reference's
    eval falls back (``Test.py:81-86``).

    Wrapper keys are what the reference writes and reads: trunks
    ``{'conv': sd}`` and the head ``{'linear': sd}`` (``Runner...py:237-264``;
    ``Test.py:100-106``), the SC under key ``'cnn'`` (``Test.py:73``), under
    its own name, the stale ``..._epoch99_DML_SC.pth`` or the ``SC_...``
    scheme; the QSC raw under ``QSC_OPT_*`` (``Runner...py:417-426``) or as
    the stale ``QSC_optimized_best.pth`` wrapped ``{'model_state_dict': sd}``
    (``Test.py:79-84``)."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    convs = []
    for i in range(3):
        p = os.path.join(src_dir, reference_ckpt_name(f"Conv{i}", batch_size, snr_db, tag))
        if os.path.exists(p):
            convs.append(load_pth(p, fallback_key="conv"))
    fc_path = os.path.join(src_dir, reference_ckpt_name("Linear", batch_size, snr_db, tag))
    if len(convs) == 3 and os.path.exists(fc_path):
        out["hdce"] = hdce_from_reference(convs, load_pth(fc_path, fallback_key="linear"))
    sc_paths = [
        os.path.join(src_dir, reference_sc_ckpt_name(batch_size, snr_db, tag)),
        os.path.join(src_dir, reference_sc_ckpt_name(batch_size, snr_db, "epoch99")),
        os.path.join(src_dir, reference_ckpt_name("SC", batch_size, snr_db, tag)),
    ]
    for sc_path in sc_paths:
        if os.path.exists(sc_path):
            out["sc"] = load_pth(sc_path, fallback_key="cnn")
            break
    qsc_paths = [
        (os.path.join(src_dir, reference_ckpt_name("QSC_OPT", batch_size, snr_db, tag)), None),
        (os.path.join(src_dir, "QSC_optimized_best.pth"), "model_state_dict"),
    ]
    for qsc_path, key in qsc_paths:
        if os.path.exists(qsc_path):
            out["qsc"] = load_pth(qsc_path, fallback_key=key)
            break
    return out


def export_reference_dir(
    out_dir: str,
    hdce_state: Mapping[str, torch.Tensor] | None = None,
    sc_state: Mapping[str, torch.Tensor] | None = None,
    qsc_state: Mapping[str, torch.Tensor] | None = None,
    batch_size: int = 256,
    snr_db: int = 10,
    tag: str = "best",
) -> list[str]:
    """Write ``.pth`` files the reference's own loaders accept, from the
    port's state dicts (``qdml_tpu/train/torch_interop.py:364-406``): the
    HDCE's trunks and head wrapped ``{'conv'|'linear': sd}``, the SC under
    the ``..._DML_SC.pth`` scheme with key ``'cnn'``, and the QSC both raw
    under ``QSC_OPT_*`` and as ``QSC_optimized_best.pth`` /
    ``model_state_dict``. Returns the paths written."""
    os.makedirs(out_dir, exist_ok=True)
    written = []

    def put(filename: str, sd: Mapping[str, torch.Tensor], wrap_key: str | None = None) -> None:
        path = os.path.join(out_dir, filename)
        save_pth(path, sd, wrap_key)
        written.append(path)

    if hdce_state is not None:
        conv_sds, fc_sd = hdce_to_reference(hdce_state)
        for i, sd in enumerate(conv_sds):
            put(reference_ckpt_name(f"Conv{i}", batch_size, snr_db, tag), sd, "conv")
        put(reference_ckpt_name("Linear", batch_size, snr_db, tag), fc_sd, "linear")
    if sc_state is not None:
        put(reference_sc_ckpt_name(batch_size, snr_db, tag), sc_state, "cnn")
    if qsc_state is not None:
        put(reference_ckpt_name("QSC_OPT", batch_size, snr_db, tag), qsc_state)
        put("QSC_optimized_best.pth", qsc_state, "model_state_dict")
    return written


def qsc_meta_from_state(sd: Mapping[str, torch.Tensor], backend: str = "auto") -> dict:
    """The architecture facts of an imported QSC, read from its weights'
    shapes (``qdml_tpu/cli.py:441-456``): qubits and layers from
    ``qlayer.weights`` (L, n, 2), classes from the classifier's bias, the
    resolved circuit path (provenance, not the ``auto`` alias), and
    ``input_norm: False`` (reference QSCs take raw pilots)."""
    from qdml_tpu_torch.quantum.circuits import resolve_backend

    n_layers, n_qubits = (int(d) for d in sd["qlayer.weights"].shape[:2])
    return {
        "n_qubits": n_qubits,
        "n_layers": n_layers,
        "n_classes": int(sd["classifier.bias"].shape[0]),
        "backend": resolve_backend(backend, n_qubits),
        "input_norm": False,
    }
