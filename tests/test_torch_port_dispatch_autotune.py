"""The routing race (``qdml_tpu_torch/ops/dispatch_autotune.py``) against the JAX package's, on the CPU.

Eligibility windows, table keys and the lookup's fallbacks are JAX's, and
the two packages read each other's table files (the same manifest-headed
format; on the CPU both key their entries ``cpu``). The race: at S = 3
nothing is timed and nothing written, at S >= 6 both modes are timed and
the entry has JAX's fields; a candidate that cannot run here is recorded,
any other failure stops the race with no table written. The serving engine
at ``serve.dispatch=auto`` resolves through it per bucket.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu.ops import dispatch_autotune as jda  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.models.qsc import build_classifier  # noqa: E402
from qdml_tpu_torch.ops import dispatch_autotune as tda  # noqa: E402
from qdml_tpu_torch.serve.engine import ServeEngine  # noqa: E402
from qdml_tpu_torch.train.hdce import build_hdce  # noqa: E402
from qdml_tpu_torch.utils import tune_table  # noqa: E402


@pytest.fixture(autouse=True)
def _isolated_tables(tmp_path, monkeypatch):
    for mod in (tda, jda):
        monkeypatch.setenv(mod.ENV_TABLE, str(tmp_path / f"{mod.__name__.split('.')[0]}.json"))
        mod.invalidate_cache()
    yield
    for mod in (tda, jda):
        mod.invalidate_cache()


def _trunks(out_dim=4):
    """A stand-in for the stacked trunks and head: (S, B', 2, H, W) -> (S, B', out_dim)."""

    def apply(xs):
        s = xs.shape[0]
        return xs.reshape(s, xs.shape[1], -1)[..., :out_dim] * torch.arange(1, s + 1)[:, None, None]

    return apply


def test_eligible_modes_and_keys_are_jax_s():
    assert tda.SPARSE_MIN_SCENARIOS == jda.SPARSE_MIN_SCENARIOS
    for s in range(1, 70):
        assert tda.eligible_modes(s) == jda.eligible_modes(s)
    for args in (("cpu", 3, 64), ("cuda", 8, 1, "float32", 2.0), ("cpu", 64, 4096, "bfloat16", 1.25)):
        assert tda.table_key(*args) == jda.table_key(*args)
    assert tda.DEFAULT_TABLE.startswith("results_torch") and tda.ENV_TABLE != jda.ENV_TABLE


def test_lookup_falls_back_to_dense_and_reads_jax_tables(tmp_path):
    path = str(tmp_path / "shared.json")
    assert tda.lookup(8, 64, path=path) is None == jda.lookup(8, 64, path=path)
    entries = {
        jda.table_key("cpu", 8, 64): {"best_infer": "sparse"},
        jda.table_key("cpu", 16, 64): {"best_infer": "dense"},
        jda.table_key("cpu", 3, 64): {"best_infer": "sparse"},   # below the window
        jda.table_key("cpu", 32, 64): {"best_infer": "bogus"},   # alien
        jda.table_key("cpu", 64, 64): "not an entry",
    }
    jda.save_table(entries, path)
    tda.invalidate_cache()  # the port cached the missing file's {} above
    for s, want in ((8, "sparse"), (16, "dense"), (3, None), (32, None), (64, None), (9, None)):
        assert tda.lookup(s, 40, path=path) == jda.lookup(s, 40, path=path) == want, s
    assert tda.lookup(8, 64, path=path, capacity_factor=2.0) is None  # another raced shape
    # the port's table is read by JAX's lookup too
    tda.invalidate_cache()
    jda.invalidate_cache()
    tda.save_table({tda.table_key("cpu", 8, 64): {"best_infer": "dense"}}, path)
    assert jda.lookup(8, 64, path=path) == "dense" == tda.lookup(8, 64, path=path)
    with open(path, "w") as fh:
        fh.write("{not json")
    tda.invalidate_cache()
    assert tda.lookup(8, 64, path=path) is None and tda.table_status(path) == "corrupt"


def test_below_the_window_nothing_is_timed_or_written(tmp_path):
    path = str(tmp_path / "t.json")
    x = torch.zeros(64, 2, 8, 4)
    before = dict(tune_table.activity)
    got = tda.ensure_route(_trunks(), x, 3, path=path)
    want = jda.ensure_route(lambda xs: xs.reshape(3, 64, -1)[..., :4], jnp.zeros((64, 8, 4, 2)), 3,
                            path=str(tmp_path / "j.json"))
    assert tune_table.activity == before
    assert got["best_infer"] == want["best_infer"] == "dense"
    assert got["candidates"] == want["candidates"] == {"dense": {"only_candidate": True}}
    assert [e["mode"] for e in got["excluded"]] == [e["mode"] for e in want["excluded"]] == ["sparse"]
    assert set(got) == set(want)
    assert not (tmp_path / "t.json").exists()


def test_the_race_times_both_modes_and_persists_its_entry(tmp_path):
    path = str(tmp_path / "t.json")
    x = torch.randn(64, 2, 8, 4)
    before = tune_table.activity["measure"]
    got = tda.ensure_route(_trunks(), x, 8, path=path, budget_s=0.01)
    want = jda.ensure_route(lambda xs: xs.reshape(8, xs.shape[1], -1)[..., :4], jnp.ones((64, 8, 4, 2)), 8,
                            path=str(tmp_path / "j.json"), budget_s=0.01)
    assert tune_table.activity["measure"] == before + 1
    assert set(got) == set(want) and "excluded" not in got
    assert set(got["candidates"]) == {"dense", "sparse"}
    assert all(rec["infer_ms"] > 0 for rec in got["candidates"].values())
    assert got["best_infer"] == min(got["candidates"], key=lambda m: got["candidates"][m]["infer_ms"])
    assert got["key"] == tda.table_key("cpu", 8, 64) and got["platform"] == "cpu"
    saved = json.loads((tmp_path / "t.json").read_text())
    assert saved["kind"] == "routing_dispatch_table" and got["key"] in saved["entries"]
    # the next ensure reads the table, and lookup finds the winner
    assert tda.ensure_route(_trunks(), x, 8, path=path) == got
    assert tune_table.activity["measure"] == before + 1
    assert tda.lookup(8, 64, path=path) == got["best_infer"]


def test_a_candidate_that_breaks_stops_the_race(tmp_path):
    """Sparse runs the trunks on (S, C) buckets, dense on (S, B): a
    failure only the sparse shape meets. "Cannot run here" is recorded and
    dense wins; any other error raises and writes nothing."""
    x = torch.randn(64, 2, 8, 4)

    def failing(err):
        def apply(xs):
            if xs.shape[1] != 64:
                raise err("the bucket shape")
            return _trunks()(xs)

        return apply

    entry = tda.ensure_route(failing(NotImplementedError), x, 8, path=str(tmp_path / "a.json"), budget_s=0.01)
    assert entry["best_infer"] == "dense" and "NotImplementedError" in entry["candidates"]["sparse"]["error"]
    with pytest.raises(RuntimeError, match="bucket shape"):
        tda.ensure_route(failing(RuntimeError), x, 8, path=str(tmp_path / "b.json"), budget_s=0.01)
    assert not (tmp_path / "b.json").exists()


def _engine_cfg(n_scenarios):
    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16, n_scenarios=n_scenarios),
        model=tconfig.ModelConfig(features=4),
        quantum=tconfig.QuantumConfig(n_classes=n_scenarios),
    )
    return dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, buckets=(4, 16)))


def _engine(cfg):
    gen = torch.Generator().manual_seed(0)
    hdce = build_hdce(cfg, "cpu", generator=gen).state_dict()
    clf = build_classifier(cfg, False, "cpu", generator=gen).state_dict()
    return ServeEngine(cfg, hdce, clf, device="cpu")


def test_engine_at_s3_resolves_dense_without_measuring():
    eng = _engine(_engine_cfg(3))
    before = dict(tune_table.activity)
    warm = eng.warmup()
    assert tune_table.activity == before and warm["work"]["measure"] == 0
    assert warm["dispatch"]["mode"] == {"4": "dense", "16": "dense"}
    for b in ("4", "16"):
        race = warm["dispatch"]["race"][b]
        assert race["candidates"] == {"dense": {"only_candidate": True}} and race["excluded"][0]["mode"] == "sparse"
    assert eng.dispatch_summary()["mode"] == "dense"


def test_engine_at_s8_races_per_bucket_then_serves_without_measuring():
    eng = _engine(_engine_cfg(8))
    warm = eng.warmup()
    assert warm["work"]["measure"] == 2 and warm["work"]["table_write"] == 2
    for b in ("4", "16"):
        race = warm["dispatch"]["race"][b]
        assert set(race["candidates"]) == {"dense", "sparse"}
        assert warm["dispatch"]["mode"][b] == race["best_infer"]
    x = np.random.default_rng(0).standard_normal((11, 16, 8, 2)).astype(np.float32)
    h, pred, conf, _ = eng.infer(x)
    ref, _, _ = eng.offline_forward(x)
    np.testing.assert_allclose(h, ref, rtol=1e-4, atol=1e-5)
    assert eng.request_path_work() == {"measure": 0, "table_write": 0, "kernel_build": 0}
    # a forced mode skips the race
    forced = _engine(dataclasses.replace(_engine_cfg(8), serve=dataclasses.replace(
        _engine_cfg(8).serve, dispatch="sparse")))
    assert forced.warmup()["dispatch"]["race"] == {"4": {"forced": "sparse"}, "16": {"forced": "sparse"}}
