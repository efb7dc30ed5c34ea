"""The port's lint gate (``qdml_tpu/analysis/``): static analysis of the
port's own tree, run by ``python -m qdml_tpu_torch.cli lint``.

An AST rule set over ``qdml_tpu_torch/`` and ``chip_smoke.py``: primary-only
collectives that deadlock a world of ranks, thread-shared serving state
touched outside its lock, dequeued futures that can be stranded, broad
excepts that swallow the typed errors, IO retries without backoff, unbounded
reads in serve paths and lifetime counters divided by wall time; plus the
slow-marker budget rule over a ``--durations`` report. Per-line
``# lint: disable=rule(reason)`` suppressions and a checked-in baseline
(``qdml_tpu_torch/analysis/lint_baseline.json``) keep the gate at zero new
findings. Its modules import the standard library alone (never JAX); the
parent package's import brings torch in, but nothing here uses it.
"""

from qdml_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    LintEngine,
    LintResult,
    ModuleContext,
    load_baseline,
    parse_suppressions,
    save_baseline,
)
from qdml_tpu_torch.analysis.rules import RULES, all_rules  # noqa: F401
