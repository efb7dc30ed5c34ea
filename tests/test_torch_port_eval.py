"""The port's end of the main path against the JAX package, on the CPU.

- Geometry and baselines: the DFTs exactly; ``ls_estimate``,
  ``mmse_estimate`` (fed JAX's ``beam_delay_profile``) and
  ``mmse_generic_estimate`` on identical inputs within 1e-5 of the largest
  entry (float32 transforms taken in another order); the port's own profile,
  drawn from its own generator, by statistics.
- Test data: ``generate_datapair``'s scenario and user assignment is JAX's
  (captured at the call into each package's ``make_network_batch``); sweep
  batches follow the JAX sweep's assignment and reuse their draws across SNR.
- The cache: ``gen-data`` writes JAX's file names, shapes and dtypes, JAX's
  ``load_npy_cache`` reads it, and it holds the training grid itself.
- One sweep batch: the port's per-batch metrics on the batch JAX's
  ``make_network_batch`` gives, with JAX's weights carried across, equal
  JAX's ``make_sweep_step`` sums within rtol 1e-4 (float32 sums over a batch
  in another order).
- The CLI: tiny ``train-*`` runs then ``eval`` write a results JSON with
  JAX's keys and MMSE below LS, into the port's own results directory.
"""

import dataclasses
import itertools
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.data import baselines as jbl  # noqa: E402
from qdml_tpu.data import channels as jch  # noqa: E402
from qdml_tpu.data import datasets as jds  # noqa: E402
from qdml_tpu.utils.complexops import CArr as JCArr  # noqa: E402
from qdml_tpu_torch import cli, interop  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.data import baselines as tbl  # noqa: E402
from qdml_tpu_torch.data import channels as tch  # noqa: E402
from qdml_tpu_torch.data import datasets as tds  # noqa: E402
from qdml_tpu_torch.eval import sweep as tsweep  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.utils.complexops import CArr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GEOM = dict(n_ant=16, n_sub=16, n_beam=8)


def _carr(x: JCArr) -> CArr:
    return CArr(torch.tensor(np.asarray(x.re)), torch.tensor(np.asarray(x.im)))


def _close(got: CArr, want: JCArr, rel=1e-5):
    wr, wi = np.asarray(want.re), np.asarray(want.im)
    tol = rel * max(np.abs(wr).max(), np.abs(wi).max())
    np.testing.assert_allclose(got.re.numpy(), wr, rtol=0, atol=tol)
    np.testing.assert_allclose(got.im.numpy(), wi, rtol=0, atol=tol)


def test_dfts_are_the_jax_ones():
    tg, jg = tch.ChannelGeometry(**GEOM), jch.ChannelGeometry(**GEOM)
    for name in ("beam_matrix", "ant_dft", "sub_dft"):
        got, want = getattr(tg, name)(), getattr(jg, name)
        np.testing.assert_array_equal(got.re.numpy(), np.asarray(want.re), err_msg=name)
        np.testing.assert_array_equal(got.im.numpy(), np.asarray(want.im), err_msg=name)
    assert tg.ant_dft() is tg.ant_dft("cpu")  # cached per device: one copy, no per-call transfer


@pytest.fixture(scope="module")
def jax_profile():
    return jbl.beam_delay_profile(jch.ChannelGeometry(**GEOM))


def test_baselines_match_jax(jax_profile):
    tg, jg = tch.ChannelGeometry(**GEOM), jch.ChannelGeometry(**GEOM)
    rng = np.random.default_rng(3)
    yp = rng.standard_normal((2, 5, 2, tg.pilot_num)).astype(np.float32)
    h_ls = rng.standard_normal((2, 5, 2, tg.h_dim)).astype(np.float32)
    jyp, jh = JCArr(jnp.asarray(yp[:, :, 0]), jnp.asarray(yp[:, :, 1])), JCArr(jnp.asarray(h_ls[:, :, 0]), jnp.asarray(h_ls[:, :, 1]))
    typ, th = _carr(jyp), _carr(jh)
    _close(tbl.ls_estimate(typ, tg), jbl.ls_estimate(jyp, jg))
    profile = torch.tensor(np.asarray(jax_profile))
    for snr in (5.0, 15.0):
        s2 = jch.label_noise_var(jg, snr)
        t2 = tch.label_noise_var(tg, snr)
        _close(tbl.mmse_estimate(th, t2, profile, tg), jbl.mmse_estimate(jh, s2, jax_profile, jg))
        _close(tbl.mmse_generic_estimate(th, t2, tg), jbl.mmse_generic_estimate(jh, s2, jg))
        np.testing.assert_allclose(float(tbl.sigma2_for_snr(tg, snr)), float(jbl.sigma2_for_snr(jg, snr)), rtol=1e-7)


def test_port_profile_agrees_with_jax_in_distribution(jax_profile):
    """The port draws its prior from its own generator: the same total power
    (E||H||^2 = h_dim) and nearly the same beam-delay shape."""
    tg = tch.ChannelGeometry(**GEOM)
    got = tbl.beam_delay_profile(tg, device="cpu").numpy()
    want = np.asarray(jax_profile)
    assert got.shape == want.shape == (16, 16)
    np.testing.assert_allclose(got.sum(), tg.h_dim, rtol=0.1)
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=0.1)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.95


@pytest.mark.parametrize("index", [-1, 1, 4])
def test_generate_datapair_assignment_is_jax(monkeypatch, index):
    seen = {}

    def jcapture(seed, scen, user, idx, snr, geom):
        seen["jax"] = (np.asarray(scen), np.asarray(user), np.asarray(idx))
        return {}

    real = tds.make_network_batch

    def tcapture(gen, scen, user, snr, geom):
        seen["port"] = (scen.numpy(), user.numpy())
        return real(gen, scen, user, snr, geom)

    monkeypatch.setattr(jds, "make_network_batch", jcapture)
    monkeypatch.setattr(tds, "make_network_batch", tcapture)
    jds.generate_datapair(11, 128, index, 10.0, 500)
    cfg = tconfig.DataConfig(**GEOM)
    out = tds.generate_datapair(11, 128, index, 10.0, 500, cfg, device="cpu")
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    np.testing.assert_array_equal(seen["port"][1], seen["jax"][1])
    np.testing.assert_array_equal(out["indicator"].numpy(), seen["jax"][0])
    assert out["yp_img"].shape == (11, 16, 8, 2) and out["h_label"].shape == (11, 512)
    again = tds.generate_datapair(11, 128, index, 10.0, 500, cfg, device="cpu")
    assert torch.equal(again["h_perf"], out["h_perf"])  # a function of (seed, start, index)
    with pytest.raises(ValueError, match="pilot_num"):
        tds.generate_datapair(11, 64, index, 10.0, 500, cfg, device="cpu")


def test_sweep_batches_follow_the_jax_assignment_and_share_draws_across_snr():
    cfg = tconfig.DataConfig(**GEOM)
    a = tds.sweep_batch(cfg, 600, 24, 12, 5.0, "cpu")
    b = tds.sweep_batch(cfg, 600, 24, 12, 15.0, "cpu")
    i = 24 + np.arange(12)
    np.testing.assert_array_equal(a["indicator"].numpy(), i % 3)
    assert torch.equal(a["h_perf"], b["h_perf"])  # the same channels at every SNR point
    ratio = ((a["h_label"] - a["h_perf"]).norm() / (b["h_label"] - b["h_perf"]).norm()).item()
    np.testing.assert_allclose(ratio, 10 ** 0.5, rtol=1e-5)  # the same unit noise, scaled by the SNR
    c = tds.sweep_batch(cfg, 600, 36, 12, 5.0, "cpu")
    assert not torch.equal(a["h_perf"], c["h_perf"])
    # never the training stream: the grid's first draws differ from every test batch's
    grid = tds.GridData.synthesize(dataclasses.replace(cfg, data_len=4), device="cpu")
    assert not torch.isclose(grid.rows["h_perf"][0, 0, 0], a["h_perf"][0]).all()


def test_gen_data_cache_is_the_jax_format_and_the_training_grid(tmp_path):
    small = dict(GEOM, data_len=6)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    flags = [f"--data.{k}={v}" for k, v in small.items()]
    assert cli.main(["gen-data", "--device=cpu", f"--out={port_dir}", *flags]) == 0
    jds.save_npy_cache(str(jax_dir), jconfig.DataConfig(**small), chunk=6)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert len(os.listdir(port_dir)) == 27
    jcfg, tcfg = jconfig.DataConfig(**small), tconfig.DataConfig(**small)
    for s, u in ((0, 0), (2, 1)):
        got = jds.load_npy_cache(str(port_dir), jcfg, s, u)  # JAX reads the port's files
        want = jds.load_npy_cache(str(jax_dir), jcfg, s, u)
        for name in ("Yp", "Hlabel", "Hperf"):
            assert got[name].shape == want[name].shape and got[name].dtype == want[name].dtype, name
        assert tds.load_npy_cache(str(port_dir), tcfg, s, u).keys() == got.keys()
    # the cache holds what GridData.synthesize trains on, at the fixed SNR
    cached = tds.GridData.from_npy_cache(str(port_dir), tcfg, device="cpu")
    synth = tds.GridData.synthesize(tcfg, device="cpu")
    idx = torch.arange(6).expand(3, 3, 6).contiguous()
    b1, b2 = cached.batch(idx, 10.0), synth.batch(idx, 10.0)
    for key in ("yp_img", "h_label", "h_perf"):
        np.testing.assert_allclose(b1[key].numpy(), b2[key].numpy(), rtol=0, atol=1e-6, err_msg=key)


def _randomize(tree, rng):
    def walk(t, name=""):
        if hasattr(t, "items"):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "kernel":
            fan_in = np.prod(a.shape[-4:-1]) if a.ndim >= 4 else a.shape[-2]
            return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def test_sweep_batch_metrics_match_jax_step(jax_profile):
    from qdml_tpu.eval.sweep import make_sweep_step
    from qdml_tpu.models.cnn import SCP128 as JSC
    from qdml_tpu.models.qsc import QSCP128 as JQSC
    from qdml_tpu.train.hdce import HDCE as JHDCE
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.train.hdce import build_hdce

    bs, n_q = 12, 4
    jcfg = jconfig.ExperimentConfig(
        data=jconfig.DataConfig(**GEOM),
        model=jconfig.ModelConfig(features=8),
        quantum=jconfig.QuantumConfig(n_qubits=n_q, n_layers=2, impl="pallas"),
        eval=jconfig.EvalConfig(batch_size=bs),
    )
    tcfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(**GEOM),
        model=tconfig.ModelConfig(features=8),
        quantum=tconfig.QuantumConfig(n_qubits=n_q, n_layers=2, impl="pallas"),
    )
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((1, 16, 8, 2))
    hdce_vars = _randomize(jax.device_get(
        JHDCE(n_scenarios=3, features=8, out_dim=512).init(key, jnp.zeros((3, 1, 16, 8, 2)), train=False)), rng)
    sc_vars = {"params": _randomize(jax.device_get(JSC(n_classes=3).init(key, x0, train=False))["params"], rng)}
    qsc_vars = {"params": _randomize(jax.device_get(
        JQSC(n_qubits=n_q, n_layers=2, impl="pallas").init(key, x0, train=False))["params"], rng)}
    jgeom = jch.ChannelGeometry.from_config(jcfg.data)
    steps = {d: make_sweep_step(jcfg, jgeom, hdce_vars, sc_vars, qsc_vars, jax_profile, dispatch=d)
             for d in ("dense", "sparse")}

    hdce = build_hdce(tcfg, "cpu")
    hdce.load_state_dict(interop.hdce_state_dict_from_flax(hdce_vars))
    sc = build_classifier(tcfg, False, "cpu")
    sc.load_state_dict(interop.sc_state_dict_from_flax(sc_vars["params"]))
    qsc = build_classifier(tcfg, True, "cpu")
    qsc.load_state_dict(interop.qsc_state_dict_from_flax(qsc_vars["params"]))
    models = tsweep.SweepModels(hdce, sc, qsc)
    tgeom = tch.ChannelGeometry.from_config(tcfg.data)
    profile = torch.tensor(np.asarray(jax_profile))
    for (start, count_base, snr), dispatch in itertools.product(((600, 0, 5.0), (600, 24, 15.0)), steps):
        step = steps[dispatch]
        want = {k: float(v) for k, v in step(jnp.asarray(start), jnp.asarray(count_base), jnp.float32(snr)).items()}
        i = count_base + jnp.arange(bs)
        jb = jds.make_network_batch(jnp.uint32(jcfg.data.seed), i % 3, (i // 3) % 3, start + i, jnp.float32(snr), jgeom)
        batch = {
            "yp_img": torch.tensor(np.asarray(jb["yp_img"])),
            "h_ls": _carr(jb["h_ls"]),
            "h_perf_c": _carr(jb["h_perf_c"]),
            "indicator": torch.tensor(np.asarray(jb["indicator"])).long(),
        }
        got = {k: float(v) for k, v in tsweep.batch_metrics(models, batch, snr, profile, tgeom, dispatch).items()}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"{dispatch} {k}")
    with pytest.raises(ValueError, match="dense|sparse"):
        tsweep.run_snr_sweep(tcfg, models, device="cpu", dispatch="nope")


def test_eval_cli_end_to_end(tmp_path, capsys):
    ws, res = tmp_path / "ws", tmp_path / "res"
    base = ["--device=cpu", f"--train.workdir={ws}", "--data.data_len=40", "--data.n_ant=16",
            "--model.features=8", "--train.batch_size=8", "--train.n_epochs=1", "--train.print_freq=1000",
            "--quantum.n_qubits=4", "--quantum.n_layers=2", "--quantum.impl=pallas"]
    for cmd in ("train-hdce", "train-sc", "train-qsc"):
        assert cli.main([cmd, *base]) == 0
    tk.reset_launch_counts()
    assert cli.main(["eval", *base, f"--eval.results_dir={res}", "--eval.test_len=32", "--eval.batch_size=16"]) == 0
    assert set(tk.launches.values()) == {0}
    out = json.loads((res / "quantum_classical_comparison.json").read_text())
    assert out["snr"] == [5.0, 7.0, 9.0, 11.0, 13.0, 15.0]
    assert set(out["nmse_db"]) == {"ls", "mmse", "mmse_oracle", "hdce_classical", "hdce_quantum"}
    assert set(out["acc"]) == {"classical", "quantum"}
    assert all(len(v) == 6 and np.isfinite(v).all() for v in out["nmse_db"].values())
    assert all(m < ls for m, ls in zip(out["nmse_db"]["mmse"], out["nmse_db"]["ls"]))
    assert (res / "results_table.md").read_text().startswith("| Curve |")
    rows = [json.loads(line) for line in (ws / "Pn_128" / "default" / "eval.metrics.jsonl").read_text().splitlines()]
    assert rows[0]["kind"] == "manifest" and rows[0]["argv"][0] == "eval"
    rows = [r for r in rows if "kind" not in r]  # the metrics records after the manifest
    assert [r["snr_db"] for r in rows] == out["snr"] and all(r["seconds"] > 0 for r in rows)
    spec = ",".join(f"{c}:{ws / 'Pn_128' / 'default' / f'train-{c}.metrics.jsonl'}" for c in ("sc", "qsc"))
    assert cli.main(["loss-curves", f"--curves={spec}", f"--eval.results_dir={res}"]) == 0
    curves = json.loads((res / "loss_curves.json").read_text())
    assert set(curves) == {"sc", "qsc"} and all(len(v) == 1 for v in curves.values())


def test_eval_config_and_results_dir():
    t, j = tconfig.EvalConfig(), jconfig.EvalConfig()
    for field, value in vars(t).items():
        if field != "results_dir":
            assert getattr(j, field) == value, field
    assert j.results_dir == "results" and t.results_dir != "results"
    assert f"{t.results_dir}/" in (ROOT / ".gitignore").read_text().split()
    cfg = tconfig.from_args(["--eval.snr_grid=5,15", "--eval.test_len=400"])
    assert cfg.eval.snr_grid == (5, 15) and cfg.eval.test_len == 400


def test_reconcile_quantum_cfg():
    from qdml_tpu_torch.train.checkpoint import reconcile_quantum_cfg

    cfg = tconfig.ExperimentConfig()
    meta = {"quantum": {"n_qubits": 4, "n_layers": 2, "n_classes": 3, "backend": "dense",
                        "impl": "pallas", "input_norm": True}}
    out = reconcile_quantum_cfg(cfg, meta)
    assert (out.quantum.n_qubits, out.quantum.n_layers, out.quantum.input_norm) == (4, 2, True)
    assert out.quantum.impl == cfg.quantum.impl  # an execution strategy: the eval config wins
    assert reconcile_quantum_cfg(cfg, {}) is cfg
    pin = dataclasses.replace(cfg, quantum=dataclasses.replace(cfg.quantum, impl="sharded_statevector"))
    with pytest.raises(ValueError, match="needs >= 2 devices"):  # one rank: ImplIneligibleError
        reconcile_quantum_cfg(pin, meta)
    pin = dataclasses.replace(cfg, quantum=dataclasses.replace(cfg.quantum, impl="pallas"))
    with pytest.raises(ValueError, match="capped"):
        reconcile_quantum_cfg(pin, {"quantum": {"n_qubits": 13}})


def test_scenario_scaling_grid_and_batch_are_jax_s():
    from qdml_tpu.eval import sweep as jsweep

    assert tsweep.SCENARIO_SCALING_GRID == jsweep.SCENARIO_SCALING_GRID
    assert [tsweep.scenario_batch(s) for s in tsweep.SCENARIO_SCALING_GRID] == [
        jsweep.scenario_batch(s) for s in jsweep.SCENARIO_SCALING_GRID
    ]


@pytest.mark.parametrize("s", [3, 8, 64])
def test_dispatch_agreement_matches_jax(s):
    """Sparse held against dense under a balanced and a fully skewed load:
    the overflow counts are JAX's (they depend on the batch, S and the
    capacity factor alone), and both packages' sparse answers sit within
    1e-5 of their dense ones (the weights differ: each package draws its
    own)."""
    from qdml_tpu.eval import sweep as jsweep

    want = jsweep.dispatch_agreement(s, batch=64)
    got = tsweep.dispatch_agreement(s, batch=64, device="cpu")
    assert set(got) == set(want) == {"max_abs_delta", "overflow_balanced", "overflow_skewed"}
    assert got["overflow_balanced"] == want["overflow_balanced"] == 0
    assert got["overflow_skewed"] == want["overflow_skewed"] == 64 - _capacity(s)
    assert got["max_abs_delta"] <= 1e-5 and want["max_abs_delta"] <= 1e-5


def _capacity(s):
    from qdml_tpu_torch.ops.routing import expert_capacity

    return expert_capacity(64, s, 1.25)
