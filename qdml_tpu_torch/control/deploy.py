"""Canary-gated deployment and the post-swap watch with rollback (``qdml_tpu/control/deploy.py``).

A fine-tuned checkpoint is a candidate, not a deploy: :meth:`Deployer.canary`
scores it against the live weights before it serves a request, and the
watch window after the swap rolls it back if serving regresses.

- **drifted probes**: fresh samples of the drifted family; the candidate
  must beat the live weights by ``min_gain_db``;
- **base probes, every scenario**: the candidate may regress no undrifted
  scenario by more than ``tol_db``; the drifted scenario's frozen-family
  numbers are reported, never gated (that family no longer exists in
  production).

Both sides run the serving engine's forward (``ServeEngine._forward``,
routing included) on an engine built from the weights on the controller's
device, as JAX's ``_probe_scorer`` jits the same forward of a throwaway
engine. :meth:`Deployer.deploy` hot-swaps through an EXPLICIT tag map
(``swap_from_workdir(tags=...)`` in process, ``{"op": "swap", "tags":
...}`` remotely), so a stale ``hdce_best`` cannot shadow the promoted
``hdce_last``; :meth:`Deployer.observe_served` watches ``watch_ticks``
ticks and swaps the recorded rollback tags back on a regression beyond
``rollback_db``.

Probes are drawn on the CPU from a generator of their own, seeded from
``(data seed, a probe-stream tag, scenario, drift step)``: ``jax.random``'s
bits cannot be reproduced, and no other consumer (training grid, eval,
loadgen) draws from that stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.control.events import emit_record
from qdml_tpu_torch.data.channels import ChannelGeometry
from qdml_tpu_torch.data.datasets import make_network_batch
from qdml_tpu_torch.telemetry.spans import span
from qdml_tpu_torch.train.checkpoint import restore_params
from qdml_tpu_torch.utils import lockdep
from qdml_tpu_torch.utils.metrics import nmse_db

# probe indices start well past both the training range and the loadgen
# offset (data_len * 3) in JAX; here it names the probe stream's seed word
PROBE_INDEX_OFFSET = 5
_PROBE_STREAM = 0x9B0E


def probe_batch(
    cfg: ExperimentConfig,
    scenario: int,
    n: int,
    drift_step: int = 0,
) -> dict[str, np.ndarray]:
    """``n`` held-out probe samples of one scenario (``drift_step > 0`` draws
    them from the DRIFTED family): ``{"x", "h_perf"}`` host arrays, users
    round-robin as JAX assigns them."""
    data = cfg.data
    if drift_step > 0:
        data = dataclasses.replace(data, drift_step=int(drift_step), drift_scenario=int(scenario))
    geom = ChannelGeometry.from_config(data)
    words = (int(cfg.data.seed), _PROBE_STREAM, PROBE_INDEX_OFFSET, int(scenario), int(drift_step))
    seed = int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))
    i = torch.arange(n)
    batch = make_network_batch(
        torch.Generator().manual_seed(seed),
        torch.full((n,), int(scenario)),
        i % cfg.data.n_users,
        cfg.data.snr_db,
        geom,
    )
    return {
        "x": batch["yp_img"].numpy().astype(np.float32),
        "h_perf": batch["h_perf"].numpy().astype(np.float32),
    }


def _state(m):
    return m.state_dict() if isinstance(m, torch.nn.Module) else m


def _probe_scorer(cfg, hdce_sd, clf_sd, quantum, device=None):
    """One engine built from the weights on ``device``, reused across every
    probe set of a canary: ``score(probes)`` is the served forward's NMSE
    (dB) against ``h_perf``, classifier routing included."""
    from qdml_tpu_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, _state(hdce_sd), _state(clf_sd), quantum=quantum, device=device)
    hdce, clf = eng.live_vars()

    def score(probes) -> float:
        xt = torch.from_numpy(probes["x"]).to(eng.device).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            h = eng._forward(hdce, clf, xt)[0].cpu().numpy()
        err = float(np.sum((h - probes["h_perf"]) ** 2))
        pow_ = float(np.sum(probes["h_perf"] ** 2))
        return nmse_db(err / pow_)

    return score


def _served_nmse_db(cfg, hdce_sd, clf_sd, quantum, probes, device=None) -> float:
    """End-to-end NMSE (dB) of the serving forward on one probe set: the
    one-shot form of :func:`_probe_scorer`."""
    return _probe_scorer(cfg, hdce_sd, clf_sd, quantum, device)(probes)


class Deployer:
    """Canary gate, explicit-tag hot-swap and post-deploy watch/rollback.

    ``swap_fn(tags)`` performs the swap (``engine.swap_from_workdir`` in
    process, the ``{"op": "swap"}`` verb remotely); the canary evaluates
    locally from the shared workdir on ``device``. The live reference may be
    given as modules or state dicts."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        workdir: str,
        swap_fn,
        live_hdce_vars=None,
        clf_vars=None,
        quantum: bool = False,
        sink=None,
        dry_run: bool = False,
        device: str | torch.device | None = None,
    ):
        ctl = cfg.control
        self.cfg = cfg
        self.workdir = workdir
        self._swap_fn = swap_fn
        self._live_hdce = live_hdce_vars
        self._clf = clf_vars
        self._quantum = quantum
        self._sink = sink
        self.dry_run = bool(dry_run)
        self.device = device
        self.probe_n = int(ctl.probe_n)
        self.min_gain_db = float(ctl.min_gain_db)
        self.tol_db = float(ctl.tol_db)
        self.watch_ticks = int(ctl.watch_ticks)
        self.rollback_db = float(ctl.rollback_db)
        self._lock = lockdep.Lock("Deployer._lock")
        # the active post-deploy watch: {"ticks_left", "ref_db",
        # "rollback_tags", "deployed_tags"}, None when nothing is watched
        self._watch: dict | None = None
        # the tag map this deployer last put live: the engine-less (remote)
        # canary resolves its live baseline from these, not from latest_tag,
        # whose best > last would bring back a stale best
        self._live_tags: dict | None = None
        # the last canaried candidate (tag, hdce, clf): a deploy of that tag
        # binds it as the live baseline (the fine-tune tag hdce_last is
        # reused every episode, so re-restoring it later would read the
        # next candidate)
        self._pending_cand: tuple | None = None

    def _emit(self, action: str, **payload) -> dict:
        return emit_record(
            self._sink, "control_event",
            action=action, dry_run=self.dry_run, **payload,
        )

    def _live_vars(self):
        """The weights serving now: the bound live pair; else the tags this
        deployer last deployed; else the newest workdir checkpoints."""
        if self._live_hdce is not None and self._clf is not None:
            return self._live_hdce, self._clf
        from qdml_tpu_torch.serve.engine import _restore_family
        from qdml_tpu_torch.train.checkpoint import CheckpointNotFoundError

        tags = self._live_tags or {}
        hdce, _, _ = _restore_family(self.workdir, "hdce", tags)
        try:
            clf, _, _ = _restore_family(self.workdir, "qsc", tags)
            quantum = True
        except CheckpointNotFoundError:
            clf, _, _ = _restore_family(self.workdir, "sc", tags)
            quantum = False
        self._quantum = quantum
        return hdce, clf

    def set_live(self, hdce_vars, clf_vars, quantum: bool | None = None) -> None:
        """Rebind the live reference after a confirmed deploy or rollback."""
        self._live_hdce = hdce_vars
        self._clf = clf_vars
        if quantum is not None:
            self._quantum = quantum

    def live_hdce_tag(self) -> str | None:
        """The hdce tag this deployer last deployed (None before any): the
        next fine-tune's warm-start base, so an episode builds on the tree
        that is serving."""
        return (self._live_tags or {}).get("hdce")

    # -- canary -------------------------------------------------------------

    def canary(self, candidate_tag: str, scenario: int, drift_step: int) -> dict:
        """Candidate against live; the canary record with ``passed`` set.
        Never swaps: :meth:`deploy` does, and only when this passed."""
        cand_vars, _ = restore_params(self.workdir, candidate_tag)
        cand = cand_vars["params"]
        live_hdce, clf = self._live_vars()
        self._pending_cand = (candidate_tag, cand, clf)
        with span("control_canary", scenario=scenario, tag=candidate_tag):
            # one engine a side for the whole canary
            score_live = _probe_scorer(self.cfg, live_hdce, clf, self._quantum, self.device)
            score_cand = _probe_scorer(self.cfg, cand, clf, self._quantum, self.device)
            drifted = probe_batch(self.cfg, scenario, self.probe_n, drift_step=drift_step)
            drift_live = score_live(drifted)
            drift_cand = score_cand(drifted)
            base: dict = {}
            worst_regress = 0.0
            for s in range(self.cfg.data.n_scenarios):
                probes = probe_batch(self.cfg, s, self.probe_n, drift_step=0)
                live_db = score_live(probes)
                cand_db = score_cand(probes)
                base[str(s)] = {"live_db": round(live_db, 3), "cand_db": round(cand_db, 3)}
                if s == scenario:
                    # the drifted scenario's frozen family no longer exists:
                    # reported, not gated
                    continue
                worst_regress = max(worst_regress, cand_db - live_db)
        gain = drift_live - drift_cand
        passed = gain >= self.min_gain_db and worst_regress <= self.tol_db
        return self._emit(
            "canary",
            passed=bool(passed),
            tag=candidate_tag,
            scenario=int(scenario),
            drift_step=int(drift_step),
            gain_db=round(gain, 3),
            min_gain_db=self.min_gain_db,
            worst_base_regress_db=round(worst_regress, 3),
            tol_db=self.tol_db,
            drifted_probes={"live_db": round(drift_live, 3), "cand_db": round(drift_cand, 3)},
            base_probes=base,
        )

    # -- deploy + watch -----------------------------------------------------

    def deploy(self, tags: dict, rollback_tags: dict, ref_db: float | None = None) -> dict:
        """Hot-swap ``tags`` live (explicit tags) and arm the watch window
        with ``rollback_tags`` as the escape hatch; ``ref_db`` is the
        served-NMSE reference the watch compares against."""
        if self.dry_run:
            return self._emit("deploy", tags=tags, skipped="dry_run")
        rec = self._swap_fn(tags)
        self._live_tags = {**(self._live_tags or {}), **tags}
        pend = self._pending_cand
        if pend is not None and pend[0] == tags.get("hdce"):
            # the canary's already-restored candidate is now the live
            # baseline, on every deploy (the in-process controller rebinds to
            # the engine's live view right after)
            self.set_live(pend[1], pend[2])
        with self._lock:
            self._watch = {
                "ticks_left": self.watch_ticks,
                "ref_db": ref_db,
                "rollback_tags": dict(rollback_tags),
                "deployed_tags": dict(tags),
            }
        return self._emit("deploy", tags=tags, swap=rec, ref_db=ref_db)

    def watching(self) -> bool:
        with self._lock:
            return self._watch is not None

    def observe_served(self, nmse_db_served: float | None) -> dict | None:
        """One watch tick with the latest served-NMSE stat (None: no
        measurement this tick, which still counts down). The rollback record
        when the watch tripped, the confirmation when the window closed
        clean, else None."""
        with self._lock:
            if self._watch is None:
                return None
            w = self._watch
            regressed = (
                nmse_db_served is not None
                and w["ref_db"] is not None
                and nmse_db_served > w["ref_db"] + self.rollback_db
            )
            w["ticks_left"] -= 1
            confirmed = w["ticks_left"] <= 0 and not regressed
            if regressed or confirmed:
                self._watch = None
        if regressed:
            rec = self._swap_fn(w["rollback_tags"])
            # the rollback tags are live: re-point the canary baseline and
            # drop the bound reference (it holds the weights just replaced)
            self._live_tags = {**(self._live_tags or {}), **w["rollback_tags"]}
            self._live_hdce = None
            self._clf = None
            return self._emit(
                "rollback",
                tags=w["rollback_tags"],
                from_tags=w["deployed_tags"],
                observed_db=round(float(nmse_db_served), 3),
                ref_db=w["ref_db"],
                rollback_db=self.rollback_db,
                swap=rec,
            )
        if confirmed:
            return self._emit("deploy_confirmed", tags=w["deployed_tags"])
        return None
