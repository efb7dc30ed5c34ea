"""The port's native IO runtime and ``NpyGridLoader`` on the CPU: the cases
of ``tests/test_native_io.py`` against the port's bindings (its own copy of
the C++ source, built with ``g++`` under ``build/``), the port's loader
against its ``DMLGridLoader`` over the same cache and against the JAX
package's ``NpyGridLoader`` on one cache the JAX package wrote, and the
build writing nothing beside either package's source."""

from __future__ import annotations

import gc
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu_torch.config import DataConfig  # noqa: E402
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData, NpyGridLoader, save_npy_cache  # noqa: E402
from qdml_tpu_torch.runtime import NativeNpyFile, PrefetchPipeline, gather_rows, native_available  # noqa: E402
from qdml_tpu_torch.runtime import native_io  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HAVE_GXX = shutil.which("g++") is not None
KEYS = ("yp_img", "h_label", "h_perf", "indicator")


def test_native_builds_under_build_when_toolchain_present():
    if HAVE_GXX:
        assert native_available(), native_io.build_error
        assert native_io.library_path().exists()
        assert native_io.library_path().parent == ROOT / "build" / "qdml_tpu_torch"
    assert native_io.SRC == ROOT / "qdml_tpu_torch" / "csrc" / "qdml_io.cpp"


def test_the_sources_c_abi_is_the_jax_packages():
    """The port's copy differs from ``native/qdml_io.cpp`` in its header
    comment alone."""
    def body(path):
        text = path.read_text()
        return text[text.index("#include <atomic>"):]

    assert body(native_io.SRC) == body(ROOT / "native" / "qdml_io.cpp")


@pytest.mark.skipif(not HAVE_GXX, reason="needs g++")
def test_a_fresh_build_writes_only_into_its_own_directory(tmp_path, monkeypatch):
    before = sorted(p.name for p in (ROOT / "native").iterdir())
    src_before = sorted(p.name for p in native_io.SRC.parent.iterdir())
    monkeypatch.setenv("QDML_NATIVE_DIR", str(tmp_path / "lib"))
    monkeypatch.setattr(native_io, "_TRIED", False)
    monkeypatch.setattr(native_io, "_LIB", None)
    assert native_io._load() is not None
    assert [p.name for p in (tmp_path / "lib").iterdir()] == [native_io.library_path().name]
    assert sorted(p.name for p in (ROOT / "native").iterdir()) == before
    assert sorted(p.name for p in native_io.SRC.parent.iterdir()) == src_before


def test_a_failed_build_degrades_to_numpy_and_says_why(tmp_path, monkeypatch):
    monkeypatch.setattr(native_io, "SRC", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setenv("QDML_NATIVE_DIR", str(tmp_path / "lib"))
    monkeypatch.setattr(native_io, "_TRIED", False)
    monkeypatch.setattr(native_io, "_LIB", None)
    monkeypatch.setattr(native_io, "build_error", None)
    assert not native_available() and native_io.build_error
    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.save(tmp_path / "a.npy", arr)
    f = NativeNpyFile(str(tmp_path / "a.npy"))
    assert not f.is_native and np.array_equal(np.asarray(f.array), arr)
    np.testing.assert_array_equal(gather_rows(arr, [3, 0]), arr[[3, 0]])
    assert not PrefetchPipeline(arr, batch=2).is_native


@pytest.mark.parametrize(
    "dtype,shape",
    [(np.float32, (37, 16)), (np.complex64, (21, 8)), (np.int64, (11,)), (np.float64, (5, 3, 4)),
     (np.int32, (6, 2)), (np.complex128, (3, 5))],
)
def test_npy_open_matches_numpy(tmp_path, dtype, shape):
    rng = np.random.default_rng(0)
    arr = rng.standard_normal(shape).astype(dtype)
    path = str(tmp_path / "a.npy")
    np.save(path, arr)
    with NativeNpyFile(path) as f:
        assert f.is_native == native_available()
        np.testing.assert_array_equal(np.asarray(f.array), arr)


def test_npy_open_falls_back_on_an_unknown_dtype(tmp_path):
    arr = np.arange(10, dtype=np.int16)
    np.save(tmp_path / "h.npy", arr)
    with NativeNpyFile(str(tmp_path / "h.npy")) as f:
        assert not f.is_native and np.array_equal(np.asarray(f.array), arr)


def test_npy_open_large_array(tmp_path):
    arr = np.arange(1000, dtype=np.float32).reshape(100, 10)
    np.save(tmp_path / "b.npy", arr)
    with NativeNpyFile(str(tmp_path / "b.npy")) as f:
        np.testing.assert_array_equal(np.asarray(f.array), arr)


@pytest.mark.parametrize("n_threads", [1, 4])
def test_gather_rows_matches_fancy_indexing(n_threads):
    rng = np.random.default_rng(1)
    src = rng.standard_normal((500, 33)).astype(np.float32)
    idx = rng.integers(0, 500, size=301)
    np.testing.assert_array_equal(gather_rows(src, idx, n_threads=n_threads), src[idx])


def test_gather_rows_complex_and_non_contiguous():
    rng = np.random.default_rng(2)
    src = (rng.standard_normal((64, 17)) + 1j * rng.standard_normal((64, 17))).astype(np.complex64)
    idx = rng.permutation(64)
    np.testing.assert_array_equal(gather_rows(src, idx), src[idx])
    strided = src[:, ::2]
    np.testing.assert_array_equal(gather_rows(strided, idx[:10]), strided[idx[:10]])


def test_prefetch_pipeline_roundtrip():
    rng = np.random.default_rng(3)
    src = rng.standard_normal((256, 24)).astype(np.float32)
    pipe = PrefetchPipeline(src, batch=32, n_slots=3, n_threads=2)
    assert pipe.is_native == native_available()
    batches = [rng.integers(0, 256, size=32) for _ in range(6)]
    tickets = [pipe.submit(batches[0]), pipe.submit(batches[1])]  # two in flight
    for i in range(2, len(batches) + 2):
        t = tickets.pop(0)
        np.testing.assert_array_equal(pipe.get(t).copy(), src[batches[i - 2]])
        pipe.release(t)
        if i < len(batches):
            tickets.append(pipe.submit(batches[i]))
    pipe.close()


def test_prefetch_partial_batch_and_its_limits():
    src = np.arange(100, dtype=np.float32).reshape(50, 2)
    pipe = PrefetchPipeline(src, batch=16, n_slots=2)
    t = pipe.submit(np.array([3, 1, 4]))
    np.testing.assert_array_equal(pipe.get(t), src[[3, 1, 4]])
    pipe.release(t)
    with pytest.raises(ValueError, match="exceed"):
        pipe.submit(np.arange(17))
    if pipe.is_native:
        t1, t2 = pipe.submit([0]), pipe.submit([1])
        with pytest.raises(RuntimeError, match="no free prefetch slot"):
            pipe.submit([2])
        pipe.release(t1)
        pipe.release(t2)
    pipe.close()
    with pytest.raises(ValueError, match="C-contiguous"):
        PrefetchPipeline(np.zeros((4, 6), np.float32)[:, ::2], batch=2)


def test_native_npy_view_outlives_file_object(tmp_path):
    arr = np.arange(64, dtype=np.float32).reshape(8, 8)
    np.save(tmp_path / "c.npy", arr)
    view = NativeNpyFile(str(tmp_path / "c.npy")).array  # the file object is unreferenced at once
    gc.collect()
    np.testing.assert_array_equal(np.asarray(view), arr)
    if native_available():
        assert not view.flags.writeable


# ---------------------------------------------------------------------------
# NpyGridLoader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = tmp_path_factory.mktemp("npy")
    cfg = DataConfig(data_len=40)
    save_npy_cache(str(d), cfg, "cpu")
    return str(d), cfg


@pytest.mark.parametrize("shuffle,epoch", [(False, 0), (True, 0), (True, 3)])
def test_npy_grid_loader_matches_dml_grid_loader(cache, shuffle, epoch):
    path, cfg = cache
    loader = NpyGridLoader(path, cfg, batch_size=8, device="cpu")
    ref = DMLGridLoader(GridData.from_npy_cache(path, cfg, "cpu"), 8)
    assert loader.is_native == native_available() and loader.steps_per_epoch == ref.steps_per_epoch
    got, want = list(loader.epoch(epoch, shuffle)), list(ref.epoch(epoch, shuffle))
    assert len(got) == len(want) == ref.steps_per_epoch
    for a, b in zip(got, want):
        for k in KEYS:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype and a[k].device == b[k].device, k
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-6)
    loader.close()


def test_npy_grid_loader_val_split_and_batch_clamp(cache):
    path, cfg = cache
    loader = NpyGridLoader(path, cfg, batch_size=64, split="val", device="cpu")
    assert loader.n == 4 and loader.batch_size == 4 and loader.steps_per_epoch == 1
    (b,) = list(loader.epoch(0, shuffle=False))
    assert b["yp_img"].shape[:3] == (cfg.n_scenarios, cfg.n_users, 4)
    with pytest.raises(ValueError, match="unknown split"):
        NpyGridLoader(path, cfg, batch_size=4, split="test", device="cpu")


def test_npy_grid_loader_matches_jaxs_on_jaxs_cache(tmp_path):
    """One cache written by the JAX package's ``save_npy_cache``, read by
    both packages' ``NpyGridLoader``: the same batches."""
    from qdml_tpu.config import DataConfig as JDataConfig
    from qdml_tpu.data.datasets import NpyGridLoader as JNpyGridLoader
    from qdml_tpu.data.datasets import save_npy_cache as jsave_npy_cache

    jcfg = JDataConfig(data_len=40)
    jsave_npy_cache(str(tmp_path), jcfg, chunk=16)
    cfg = DataConfig(data_len=40)
    mine = NpyGridLoader(str(tmp_path), cfg, batch_size=8, device="cpu")
    theirs = JNpyGridLoader(str(tmp_path), jcfg, batch_size=8)
    assert mine.steps_per_epoch == theirs.steps_per_epoch
    for shuffle in (False, True):
        got, want = list(mine.epoch(1, shuffle)), list(theirs.epoch(1, shuffle))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for k in KEYS:
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    mine.close()
    theirs.close()


def test_npy_grid_loader_refuses_snr_jitter(cache):
    path, cfg = cache
    from dataclasses import replace

    with pytest.raises(ValueError, match="snr_jitter is impossible"):
        NpyGridLoader(path, replace(cfg, snr_jitter=(0.0, 10.0)), batch_size=8, device="cpu")


def test_npy_grid_loader_early_break_and_error(cache):
    """An abandoned epoch leaves no producer stuck, and an assembly error
    reaches the consumer instead of hanging it."""
    path, cfg = cache
    loader = NpyGridLoader(path, cfg, batch_size=4, device="cpu")
    before = threading.active_count()
    for _ in range(3):
        for _batch in loader.epoch(0):
            break  # abandon at once
    assert threading.active_count() <= before + 1

    def boom(idx):
        raise RuntimeError("bad row")

    loader._assemble = boom
    with pytest.raises(RuntimeError, match="bad row"):
        for _batch in loader.epoch(1):
            pass
    loader.close()


def test_npy_grid_loader_runs_on_the_card_unless_asked(cache, monkeypatch):
    path, cfg = cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        NpyGridLoader(path, cfg, batch_size=4)


def test_an_hdce_step_fed_from_the_npy_loader_equals_one_fed_from_the_grid(cache):
    from qdml_tpu_torch import config as tconfig
    from qdml_tpu_torch.train import hdce as thdce

    path, data_cfg = cache
    cfg = tconfig.ExperimentConfig(data=data_cfg, model=tconfig.ModelConfig(features=8),
                                   train=tconfig.TrainConfig(batch_size=8))
    losses = []
    for batch in (next(iter(NpyGridLoader(path, data_cfg, 8, device="cpu").epoch(0))),
                  next(iter(DMLGridLoader(GridData.from_npy_cache(path, data_cfg, "cpu"), 8).epoch(0)))):
        model, opt = thdce.make_trainer(cfg, "cpu", 4)
        m = thdce._step_fn(model, opt, probes=True)(batch, None)
        losses.append((float(m["loss"]), [p.detach().clone() for p in model.parameters()]))
    assert losses[0][0] == losses[1][0]
    assert all(torch.equal(a, b) for a, b in zip(losses[0][1], losses[1][1]))
