"""The K-step training path (``qdml_tpu_torch/train/scan.py``) on the CPU.

Against the JAX package: each trainer at ``train.scan_steps=3`` (4 steps an
epoch, so every epoch ends in a 1-step tail) against JAX's ``train_*`` at
the same K, from JAX's initial weights over the ``.npy`` cache JAX's
``save_npy_cache`` wrote (the samples JAX's scan synthesizes), to the
history tests' tolerances: losses rtol 2e-4 (float32 sums in another order
over 8 steps), validation accuracy one prediction in 36. The noise-sweep
ensemble's chunks are fed JAX's own QuantumNAT draws, recomputed from the
keys JAX's scan splits (``presplit_keys``), as
``tests/test_torch_port_nat_sweep.py`` feeds its per-step draws.

Within the port: ``scan_steps=K`` takes the same steps as ``scan_steps=0``
bit for bit (on the CPU a chunk is its steps run eagerly); the chunks are
JAX's ``epoch_chunks``; ``scan_eligible`` decides as JAX's does; the rate,
a tensor, follows the halving schedule across an epoch boundary and a chunk
may not cross one; an epoch writes one ``scan_call`` span a chunk. The CUDA
graph's own checks (its spans among them) are in
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``'s scan phase.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.data.channels import ChannelGeometry as JGeometry  # noqa: E402
from qdml_tpu.data.datasets import DMLGridLoader as JLoader  # noqa: E402
from qdml_tpu.data.datasets import save_npy_cache  # noqa: E402
from qdml_tpu.train import dce as jdce  # noqa: E402
from qdml_tpu.train import hdce as jhdce  # noqa: E402
from qdml_tpu.train import nat_sweep as jsweep  # noqa: E402
from qdml_tpu.train import qsc as jqsc  # noqa: E402
from qdml_tpu.train.scan import presplit_keys  # noqa: E402
from qdml_tpu.train.scan import scan_eligible as jscan_eligible  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData  # noqa: E402
from qdml_tpu_torch.train import dce as tdce  # noqa: E402
from qdml_tpu_torch.train import hdce as thdce  # noqa: E402
from qdml_tpu_torch.train import nat_sweep as tsweep  # noqa: E402
from qdml_tpu_torch.train import qsc as tqsc  # noqa: E402
from qdml_tpu_torch.train import scan as tscan  # noqa: E402

# HDCE and DCE at a narrow geometry; the classifiers need 16 x 8 pilot images
ESTIMATOR = dict(n_ant=16, n_sub=8, n_beam=4, data_len=40)
CLASSIFIER = dict(n_ant=16, n_sub=16, n_beam=8, data_len=40)
TRAIN = dict(batch_size=8, n_epochs=2, print_freq=1000, scan_steps=3)
QUANTUM = dict(n_qubits=4, n_layers=2, impl="pallas_circuit")
LEVELS = (0.0, 0.05, 0.1)


class Recorder:
    def __init__(self):
        self.records = []

    def log(self, **values):
        self.records.append(values)


def _cfgs(data, quantum=None, features=8, **train):
    tkw = {**TRAIN, **train}
    qkw = quantum or {}
    jcfg = jconfig.ExperimentConfig(
        data=jconfig.DataConfig(**data), model=jconfig.ModelConfig(features=features),
        quantum=jconfig.QuantumConfig(**qkw), train=jconfig.TrainConfig(**tkw),
    )
    tcfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(**data), model=tconfig.ModelConfig(features=features),
        quantum=tconfig.QuantumConfig(**qkw), train=tconfig.TrainConfig(**tkw),
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    out = {}
    for name, data in (("estimator", ESTIMATOR), ("classifier", CLASSIFIER)):
        path = tmp_path_factory.mktemp(name)
        save_npy_cache(str(path), jconfig.DataConfig(**data), chunk=40)
        out[name] = str(path)
    return out


def _bn_state(state):
    return {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}


@pytest.mark.parametrize("trainer", ["hdce", "dce", "sc", "qsc"])
def test_trainer_scan_history_matches_jax_at_the_same_k(caches, trainer):
    data_kw = ESTIMATOR if trainer in ("hdce", "dce") else CLASSIFIER
    jcfg, tcfg = _cfgs(data_kw, QUANTUM if trainer == "qsc" else None)
    data = GridData.from_npy_cache(
        caches["estimator" if trainer in ("hdce", "dce") else "classifier"], tcfg.data, device="cpu"
    )
    rec = Recorder()
    if trainer == "hdce":
        _, jhist = jhdce.train_hdce(jcfg)
        init = interop.hdce_state_dict_from_flax(_bn_state(jhdce.init_hdce_state(jcfg, 4)[1]), tcfg.image_hw)
        _, hist = thdce.train_hdce(tcfg, data=data, init_state=init, logger=rec)
    elif trainer == "dce":
        _, jhist = jdce.train_dce(jcfg)
        init = interop.dce_state_dict_from_flax(_bn_state(jdce.init_dce_state(jcfg, 4)[1]), tcfg.image_hw)
        _, hist = tdce.train_dce(tcfg, data=data, init_state=init, logger=rec)
    else:
        quantum = trainer == "qsc"
        _, jhist = jqsc.train_classifier(jcfg, quantum=quantum)
        convert = interop.qsc_state_dict_from_flax if quantum else interop.sc_state_dict_from_flax
        init = convert(jax.device_get(jqsc.init_sc_state(jcfg, quantum, steps_per_epoch=4)[1].params))
        _, hist = tqsc.train_classifier(tcfg, quantum, data=data, init_state=init, logger=rec)
    assert rec.records[0] == {
        "kind": "scan_dispatch", "eligible": True, "scan_steps": 3, "reason": rec.records[0]["reason"]
    }
    assert set(hist) == set(jhist)
    for key in jhist:
        assert len(hist[key]) == 2
        if key == "val_acc":
            np.testing.assert_allclose(hist[key], jhist[key], rtol=0, atol=1 / 36 + 1e-9)
        else:
            np.testing.assert_allclose(hist[key], jhist[key], rtol=2e-4, err_msg=key)


def _jax_member_noise(jparams, keys):
    """The unit draws JAX's ``perturb`` makes for each member's circuit
    weights from its key (``tests/test_torch_port_nat_sweep.py:_jax_noise``)."""
    member = jax.tree.map(lambda x: x[0], jparams)
    leaves = jax.tree_util.tree_leaves_with_path(member)
    (idx,) = [i for i, (path, _) in enumerate(leaves) if jsweep._is_qweight(path, None)]
    shape = leaves[idx][1].shape
    draws = [jax.random.normal(jax.random.split(keys[m], len(leaves))[idx], shape) for m in range(len(LEVELS))]
    return np.stack([np.asarray(d) for d in draws])


def test_sweep_scan_chunks_match_jax_with_its_noise(caches):
    jcfg, tcfg = _cfgs(CLASSIFIER, dict(n_qubits=4, n_layers=2, noise_sweep=LEVELS))
    geom = JGeometry.from_config(jcfg.data)
    loader = JLoader(jcfg.data, jcfg.train.batch_size, "train", geom)
    model, tx, jparams, jopt, jsigmas = jsweep.init_sweep(jcfg, LEVELS, loader.steps_per_epoch)
    jrun = jsweep.make_sweep_scan_steps(model, tx, jsigmas, geom, probes=False)
    host = jax.device_get(jparams)
    states = [interop.qsc_state_dict_from_flax(jax.tree.map(lambda x, m=m: np.asarray(x)[m], host))
              for m in range(len(LEVELS))]
    tmodel, params, opt, sigmas = tsweep.init_sweep(tcfg, LEVELS, loader.steps_per_epoch, torch.device("cpu"), states)
    data = GridData.from_npy_cache(caches["classifier"], tcfg.data, device="cpu")
    run = tsweep.make_sweep_scan_steps(tmodel, params, opt, sigmas, data, 3)
    rng = jax.random.PRNGKey(5)
    seed = jax.numpy.uint32(jcfg.data.seed)
    scen, user = loader.grid_coords
    lengths = []
    for idx, snrs in loader.epoch_chunks(0, 3):
        rng, subs = presplit_keys(rng, idx.shape[0])
        member_keys = jax.vmap(lambda s: jax.random.split(s, len(LEVELS)))(subs)
        (jparams, jopt), jm = jrun((jparams, jopt), seed, scen, user, idx, snrs, member_keys)
        noise = torch.from_numpy(np.stack([_jax_member_noise(jparams, member_keys[j]) for j in range(idx.shape[0])]))
        tm = run(np.asarray(idx).astype(np.int64), np.asarray(snrs), noise)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), rtol=2e-4)
        lengths.append(idx.shape[0])
    assert lengths == [3, 1]
    want = [interop.qsc_state_dict_from_flax(jax.tree.map(lambda x, m=m: np.asarray(x)[m], jax.device_get(jparams)))
            for m in range(len(LEVELS))]
    bound = 1.1 * 4 * tcfg.train.lr + 1e-5
    for m in range(len(LEVELS)):
        got = tsweep.member_state(params, m)
        outside = total = 0
        for k, w in want[m].items():
            diff = (got[k] - w).abs()
            assert diff.max().item() <= bound, (m, k)
            outside += int((diff > 1e-5 + 1e-4 * w.abs()).sum())
            total += w.numel()
        assert outside <= 0.01 * total


def _train(trainer, cfg, data):
    rec = Recorder()
    if trainer == "hdce":
        model, hist = thdce.train_hdce(cfg, data=data, logger=rec)
    elif trainer == "dce":
        model, hist = tdce.train_dce(cfg, data=data, logger=rec)
    elif trainer == "nat_sweep":
        model, hist = tsweep.train_nat_sweep(cfg, noise_levels=(0.0, 0.1), data=data, logger=rec)
    else:
        model, hist = tqsc.train_classifier(cfg, trainer == "qsc", data=data, logger=rec)
    params = model if isinstance(model, dict) else model.state_dict()
    return hist, {k: v.detach().clone() for k, v in params.items()}, rec.records


@pytest.mark.parametrize("trainer,k", [("hdce", 1), ("hdce", 3), ("dce", 3), ("sc", 3), ("qsc", 3), ("nat_sweep", 3)])
def test_scan_steps_equal_the_per_step_path_bitwise(trainer, k):
    """QSC with QuantumNAT on: the chunks draw the generator's stream in the
    per-step order; print_freq 1 with probe_every 1 (the K-step path fetches
    a chunk's losses on the probe cadence, as JAX's does) logs every chunk's
    losses."""
    data_kw = ESTIMATOR if trainer in ("hdce", "dce") else CLASSIFIER
    quantum = dict(n_qubits=4, n_layers=2, use_quantumnat=True, noise_level=0.05)
    _, cfg0 = _cfgs(data_kw, quantum, features=4, scan_steps=0, print_freq=1, probe_every=1)
    data = GridData.synthesize(cfg0.data, "cpu")
    hist0, params0, recs0 = _train(trainer, cfg0, data)
    _, cfgk = _cfgs(data_kw, quantum, features=4, scan_steps=k, print_freq=1, probe_every=1)
    histk, paramsk, recsk = _train(trainer, cfgk, data)
    for key in hist0:
        assert np.array_equal(np.asarray(histk[key]), np.asarray(hist0[key])), key
    for name in params0:
        assert torch.equal(paramsk[name], params0[name]), name
    step_losses0 = [r["loss"] for r in recs0 if "loss" in r]
    step_lossesk = [x for r in recsk if "losses" in r for x in r["losses"]]
    assert step_lossesk == step_losses0 and len(step_losses0) == 8
    assert [r["eligible"] for r in recs0 + recsk if r.get("kind") == "scan_dispatch"] == [False, True]


@pytest.mark.parametrize("k", [1, 3, 4, 5])
@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_chunks_equal_jax(k, shuffle):
    data_kw = dict(ESTIMATOR, snr_jitter=(5.0, 15.0))
    jcfg, tcfg = _cfgs(data_kw)
    jl = JLoader(jcfg.data, 8, "train")
    tl = DMLGridLoader(GridData.synthesize(tcfg.data, "cpu"), 8, "train")
    got = list(tl.epoch_chunks(1, k, shuffle))
    want = list(jl.epoch_chunks(1, k, shuffle))
    assert len(got) == len(want) == -(-4 // k)
    for (gi, gs), (wi, ws) in zip(got, want):
        assert gi.dtype == np.int64 and np.array_equal(gi, np.asarray(wi))
        assert gs.dtype == np.float32 and np.array_equal(gs, np.asarray(ws))
    # the chunks are the per-step iterator's windows and SNRs
    steps = list(tl.epoch(1, shuffle))
    flat = [w for chunk, _ in got for w in chunk]
    assert all(np.array_equal(b["index"].numpy(), w) for b, w in zip(steps, flat))
    with pytest.raises(ValueError, match="k >= 1"):
        next(tl.epoch_chunks(0, 0))


@pytest.mark.parametrize("k", [0, 1, 4])
def test_scan_eligible_gives_jax_decisions(k):
    jcfg, tcfg = _cfgs(ESTIMATOR, scan_steps=k)
    jrec, trec = Recorder(), Recorder()
    jeligible = jscan_eligible(jcfg, None, JLoader(jcfg.data, 8, "train"), jrec)
    teligible = tscan.scan_eligible(tcfg, trec, torch.device("cpu"))
    assert teligible == jeligible == (k >= 1)
    (j,), (t,) = jrec.records, trec.records
    assert {key: t[key] for key in ("kind", "eligible", "scan_steps")} == {
        key: j[key] for key in ("kind", "eligible", "scan_steps")
    }
    assert t["reason"].split(":")[0] == j["reason"].split(":")[0]


def test_scan_eligible_declines_sgd_on_the_card_and_the_config_refuses_negative_k():
    _, tcfg = _cfgs(ESTIMATOR, optimizer="sgd")
    rec = Recorder()
    assert tscan.scan_eligible(tcfg, rec, torch.device("cuda")) is False
    assert rec.records[0]["reason"].startswith("optimizer:") and "warning" in rec.records[1]
    assert tscan.scan_eligible(tcfg, Recorder(), torch.device("cpu")) is True
    with pytest.raises(ValueError, match="scan_steps"):
        tconfig.TrainConfig(scan_steps=-1)
    with pytest.raises(ValueError, match="scan_steps"):
        tconfig.from_args(["--train.scan_steps=-2"])


def test_tensor_rate_follows_the_halving_schedule_across_an_epoch_boundary():
    _, cfg = _cfgs(ESTIMATOR, features=4, lr_decay_epochs=1, lr=1e-3)
    data = GridData.synthesize(cfg.data, "cpu")
    loader = DMLGridLoader(data, 8, "train")
    model, opt = thdce.make_trainer(cfg, "cpu", loader.steps_per_epoch)
    seen = []

    def step(batch, _noise):
        seen.append((float(opt.lr), opt.opt.param_groups[0]["lr"]))
        return thdce.hdce_train_step(model, opt, batch)

    run = tscan.make_scan_steps(step, data, opt, 3)
    for epoch in range(2):
        tscan.run_epoch(run, loader, epoch, Recorder(), 1000)
    rates = [np.float32(1e-3)] * 4 + [np.float32(5e-4)] * 4
    assert [r for r, _ in seen] == rates and [g for _, g in seen] == [1e-3] * 4 + [5e-4] * 4
    assert opt.count == 8 and opt.lr.dtype == torch.float32 and opt.lr.dim() == 0
    # a chunk that would cross the boundary is refused before any step
    opt.count = 2
    with pytest.raises(ValueError, match="epoch boundary"):
        opt.pin_rate(3)
    assert opt.pin_rate(2) == 1e-3 and float(opt.lr) == np.float32(1e-3)
    opt.unpin_rate()


def test_a_k_step_epoch_writes_one_scan_call_a_chunk_with_its_k():
    """On the CPU a chunk runs eagerly: its ``scan_call`` span, tagged with
    the chunk's length, sits in the epoch's span and has no children and
    no phases."""
    from qdml_tpu_torch.telemetry import set_sink

    class Spans:
        active = True

        def __init__(self):
            self.records = []

        def write_raw(self, rec):
            self.records.append(rec)

    _, cfg = _cfgs(ESTIMATOR, features=4)
    data = GridData.synthesize(cfg.data, "cpu")
    loader = DMLGridLoader(data, 8, "train")
    model, opt = thdce.make_trainer(cfg, "cpu", loader.steps_per_epoch)
    run = thdce.make_hdce_scan_steps(model, opt, data, 3)
    sink = Spans()
    set_sink(sink)
    try:
        tscan.run_epoch(run, loader, 0, Recorder(), 1000)
    finally:
        set_sink(None)
    assert [r["name"] for r in sink.records] == ["scan_call", "scan_call", "train_epoch"]
    calls, (epoch,) = sink.records[:-1], sink.records[-1:]
    assert [r["k"] for r in calls] == [len(snrs) for _, snrs in loader.epoch_chunks(0, 3)] == [3, 1]
    assert all(r["path"] == "train_epoch/scan_call" and r["depth"] == 1 and "phases" not in r for r in calls)
    assert epoch["t0_ns"] <= calls[0]["t0_ns"] <= calls[0]["t1_ns"] <= calls[1]["t0_ns"] <= epoch["t1_ns"]


def test_a_chunk_longer_than_k_or_without_its_noise_is_refused():
    _, cfg = _cfgs(ESTIMATOR, features=4)
    data = GridData.synthesize(cfg.data, "cpu")
    model, opt = thdce.make_trainer(cfg, "cpu", 4)
    run = thdce.make_hdce_scan_steps(model, opt, data, 2)
    idx = np.zeros((3, 3, 3, 8), np.int64)
    with pytest.raises(ValueError, match="want 1..2"):
        run(idx, np.full(3, 10.0, np.float32))
    with pytest.raises(ValueError, match="noise"):
        run(idx[:2], np.full(2, 10.0, np.float32), torch.zeros(2, 1))
    assert opt.count == 0


def test_a_resume_state_saved_on_the_card_loads_on_the_cpu():
    """A card's optimizer state is capturable (step counts on the card); a
    CPU optimizer loading it keeps its own, non-capturable groups and steps."""
    _, cfg = _cfgs(ESTIMATOR, features=4)
    model, opt = thdce.make_trainer(cfg, "cpu", 4)
    data = GridData.synthesize(cfg.data, "cpu")
    batch = next(iter(DMLGridLoader(data, 8, "train").epoch(0)))
    thdce.hdce_train_step(model, opt, batch)
    saved = opt.state_dict()
    for group in saved["opt"]["param_groups"]:
        group["capturable"] = True  # as the card writes it
    model2, opt2 = thdce.make_trainer(cfg, "cpu", 4)
    opt2.load_state_dict(saved)
    assert opt2.count == 1 and not opt2.tensor_lr
    assert all(group["capturable"] is False for group in opt2.opt.param_groups)
    thdce.hdce_train_step(model2, opt2, batch)
    assert opt2.count == 2
