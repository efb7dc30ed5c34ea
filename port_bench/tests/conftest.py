"""Shared set-up of the benchmark's own tests: the repository's root on the
path, the program's dispatch tables in the test's temporary directory, and
a small size at which the CPU runs a whole cell in seconds."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the configuration's shapes cut to what the CPU runs in seconds
TINY = {"data.n_ant": 4, "model.features": 4, "train.batch_size": 8, "train.scan_steps": 2}


@pytest.fixture(autouse=True)
def _tables(tmp_path, monkeypatch):
    for key in ("QDML_TORCH_QSC_AUTOTUNE_TABLE", "QDML_TORCH_ROUTING_AUTOTUNE_TABLE",
                "QDML_TORCH_SERVE_BATCHING_TABLE"):
        monkeypatch.setenv(key, str(tmp_path / f"{key.lower()}.json"))


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
