"""The port's data layer against the JAX package, on the CPU.

- The family table and geometry constants are verbatim copies: exact.
- The deterministic transform of the draws: JAX's own draws, replayed from
  its ``make_sample_key`` and key splits, go through the port's transform and
  must give JAX's ``generate_samples`` (channel, pilots, LS label) to 1e-6
  of the largest entry (float32 rounding of a 20-path sum and the DFT).
- Over a cache JAX's ``save_npy_cache`` wrote, the port's loader yields the
  batches of JAX's ``DMLGridLoader`` for two epochs: the indices exactly, the
  values to float32 rounding (rtol 1e-5, atol 1e-6, the JAX package's own
  cache-vs-synthesis tolerance, ``tests/test_native_io.py``).
- The port's own generator, whose draws cannot be JAX's, is held by
  statistics: unit channel power per scenario, channel ranks within each
  scenario's path count, and the LS label NMSE at 2.8 - SNR dB.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu.config import DataConfig as JDataConfig  # noqa: E402
from qdml_tpu.data import channels as jch  # noqa: E402
from qdml_tpu.data import datasets as jds  # noqa: E402
from qdml_tpu_torch.config import DataConfig  # noqa: E402
from qdml_tpu_torch.data import channels as tch  # noqa: E402
from qdml_tpu_torch.data import datasets as tds  # noqa: E402


@pytest.mark.parametrize("s", [1, 3, 7, 12])
@pytest.mark.parametrize("drift", [(0, -1), (2, 0), (3, -1)])
def test_family_table_is_the_jax_table(s, drift):
    got, want = tch.family_table(s, *drift), jch.family_table(s, *drift)
    assert set(got) == set(want)
    for k in want:
        if k == "preset":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_geometry_constants_match():
    assert tch.MAX_PATHS == jch.MAX_PATHS
    np.testing.assert_array_equal(tch.USER_CENTER_F, jch.USER_CENTER_F)
    tg, jg = tch.ChannelGeometry(n_ant=32, n_sub=16, n_beam=8), jch.ChannelGeometry(n_ant=32, n_sub=16, n_beam=8)
    assert (tg.pilot_num, tg.h_dim, tg.noise_ref_power) == (jg.pilot_num, jg.h_dim, jg.noise_ref_power)
    bm = tg.beam_matrix()
    np.testing.assert_array_equal(bm.re.numpy(), np.asarray(jg.beam_matrix.re))
    np.testing.assert_array_equal(bm.im.numpy(), np.asarray(jg.beam_matrix.im))
    for snr in (5.0, 12.5):
        np.testing.assert_allclose(float(tch.noise_var(tg, snr)), float(jch.noise_var(jg, snr)), rtol=1e-7)
        np.testing.assert_allclose(
            float(tch.label_noise_var(tg, snr)), float(jch.label_noise_var(jg, snr)), rtol=1e-7
        )
    cfg = DataConfig(n_ant=32, label_noise_factor=2.5)
    assert tch.ChannelGeometry.from_config(cfg).label_noise_factor == 2.5


def _jax_draws(seed, scen, user, idx, jgeom):
    """JAX's own random numbers for each sample, replayed from its key
    derivation: make_sample_key, the (h, pilots, label) split, and
    sample_channel's (angle, delay, gain) split plus the mobility fold_in."""
    mobile = np.any(jch.family_table(jgeom.n_scenarios)["mobility"] > 0)

    def one(s, u, i):
        key = jch.make_sample_key(seed, s, u, i)
        k_h, k_n, k_l = jax.random.split(key, 3)
        k_f, k_tau, k_gain = jax.random.split(k_h, 3)
        out = {
            "trunc": jax.random.truncated_normal(k_f, -2.0, 2.0, (jch.MAX_PATHS,)),
            "expo": jax.random.exponential(k_tau, (jch.MAX_PATHS,)),
            "gain": jax.random.normal(k_gain, (jch.MAX_PATHS, 2)),
            "pilot_noise": jax.random.normal(k_n, (2, jgeom.pilot_num)),
            "label_noise": jax.random.normal(k_l, (2, jgeom.h_dim)),
        }
        if mobile:
            out["phi"] = jax.random.normal(jax.random.fold_in(k_h, 7), (jch.MAX_PATHS,))
        return out

    return {k: torch.tensor(np.asarray(v)) for k, v in jax.vmap(one)(scen, user, idx).items()}


@pytest.mark.parametrize("n_scenarios", [3, 6])
def test_transform_of_jax_draws_matches_generate_samples(n_scenarios):
    jgeom = jch.ChannelGeometry(n_ant=32, n_sub=16, n_beam=8, n_scenarios=n_scenarios)
    tgeom = tch.ChannelGeometry(n_ant=32, n_sub=16, n_beam=8, n_scenarios=n_scenarios)
    rng = np.random.default_rng(n_scenarios)
    n = 12
    scen = rng.integers(0, n_scenarios, n).astype(np.int32)
    user = rng.integers(0, 3, n).astype(np.int32)
    idx = rng.integers(0, 1000, n).astype(np.int32)
    seed, snr = 2026, 7.5
    want = jch.generate_samples(
        jnp.uint32(seed), jnp.asarray(scen), jnp.asarray(user), jnp.asarray(idx),
        jnp.float32(snr), jgeom,
    )
    draws = _jax_draws(jnp.uint32(seed), jnp.asarray(scen), jnp.asarray(user), jnp.asarray(idx), jgeom)
    assert ("phi" in draws) == (n_scenarios > 3)
    ts, tu = torch.tensor(scen), torch.tensor(user)
    h = tch.channels_from_draws(draws, ts, tu, tgeom)
    yp = tch.sound_pilots(h, draws["pilot_noise"], snr, tgeom)
    h_ls = tch.ls_label(h, draws["label_noise"], snr, tgeom)
    hf = h.reshape(n, tgeom.h_dim)
    for got, ref in ((hf, want["h_perf"]), (yp, want["yp"]), (h_ls, want["h_ls"])):
        tol = 1e-6 * max(np.abs(np.asarray(ref.re)).max(), np.abs(np.asarray(ref.im)).max())
        np.testing.assert_allclose(got.re.numpy(), np.asarray(ref.re), rtol=0, atol=tol)
        np.testing.assert_allclose(got.im.numpy(), np.asarray(ref.im), rtol=0, atol=tol)


def test_truncated_normal_matches_jax_inverse_cdf():
    """The inverse-CDF draw stays inside (-2, 2) with the truncated normal's
    variance, and its mean agrees with JAX's sampler on as many draws."""
    gen = torch.Generator().manual_seed(0)
    x = tch.truncated_normal(gen, (20000,))
    assert float(x.min()) > -2.0 and float(x.max()) < 2.0
    # variance of N(0, 1) truncated to [-2, 2]: 1 - 4 phi(2) / (2 Phi(2) - 1)
    np.testing.assert_allclose(float(x.var()), 0.7737, atol=0.02)
    jx = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(0), -2.0, 2.0, (20000,)))
    np.testing.assert_allclose(float(x.mean()), float(jx.mean()), atol=0.03)


def _small(**kw):
    return dict(n_ant=16, n_sub=16, n_beam=8, data_len=24, **kw)


def test_npy_cache_batches_match_jax_grid_loader(tmp_path):
    jcfg = JDataConfig(**_small())
    tcfg = DataConfig(**_small())
    jds.save_npy_cache(str(tmp_path), jcfg, chunk=24)
    data = tds.GridData.from_npy_cache(str(tmp_path), tcfg, device="cpu")
    for split, shuffles in (("train", (True, True)), ("val", (False,))):
        jl = jds.DMLGridLoader(jcfg, batch_size=5, split=split)
        tl = tds.DMLGridLoader(data, batch_size=5, split=split)
        assert (tl.steps_per_epoch, tl.batch_size, tl.index_base, tl.n) == (
            jl.steps_per_epoch, jl.batch_size, jl.index_base, jl.n
        )
        for epoch, shuffle in enumerate(shuffles):
            perms = jds._epoch_perms(jcfg, jl.n, jl.index_base, epoch, shuffle)
            jb = list(jl.epoch(epoch, shuffle=shuffle))
            tb = list(tl.epoch(epoch, shuffle=shuffle))
            assert len(jb) == len(tb) == jl.steps_per_epoch
            for step, (j, t) in enumerate(zip(jb, tb)):
                np.testing.assert_array_equal(
                    t["index"].numpy(), perms[:, :, step * 5 : (step + 1) * 5]
                )
                np.testing.assert_array_equal(t["indicator"].numpy(), np.asarray(j["indicator"]))
                for key in ("yp_img", "h_label", "h_perf"):
                    assert t[key].shape == j[key].shape
                    np.testing.assert_allclose(
                        t[key].numpy(), np.asarray(j[key]), rtol=1e-5, atol=1e-6
                    )


def test_npy_cache_refuses_snr_jitter(tmp_path):
    with pytest.raises(ValueError, match="snr_jitter"):
        tds.GridData.from_npy_cache(str(tmp_path), DataConfig(snr_jitter=(5.0, 15.0)), device="cpu")


def test_split_perms_and_names_are_the_jax_ones():
    cfg, jcfg = DataConfig(data_len=50, seed=9), JDataConfig(data_len=50, seed=9)
    for split in ("train", "val"):
        assert tds._resolve_split(cfg, split) == jds._resolve_split(jcfg, split)
    for shuffle in (True, False):
        np.testing.assert_array_equal(
            tds._epoch_perms(cfg, 45, 0, 3, shuffle), jds._epoch_perms(jcfg, 45, 0, 3, shuffle)
        )
    assert tds._npy_names("d", cfg, 2, 1) == jds._npy_names("d", jcfg, 2, 1)
    jitter = dataclasses.replace(cfg, snr_jitter=(5.0, 15.0))
    loader = tds.DMLGridLoader(tds.GridData(jitter, {"h_perf": torch.zeros(1)}, cached=False), 8)
    jloader = jds.DMLGridLoader(dataclasses.replace(jcfg, snr_jitter=(5.0, 15.0)), 8)
    for epoch, step in ((0, 0), (2, 3)):
        assert loader._step_snr(epoch, step) == jloader._step_snr(epoch, step)
        assert loader._snr_for(epoch, step, False) == 10.0


def test_synthesized_grid_statistics():
    """The port's generator: per-scenario unit channel power, channel ranks
    bounded by each scenario's path count (3, 8 and min(20, n_sub) paths;
    weak late paths fall under the numerical rank, so each scenario only has
    to exceed the previous one's count), and an LS label whose NMSE tracks
    10*log10(1.9) - SNR (the label noise variance)."""
    cfg = DataConfig(data_len=240)
    data = tds.GridData.synthesize(cfg, device="cpu")
    h = data.rows["h_perf"]  # (S, U, N, 2 * h_dim)
    power = (h**2).reshape(3, -1, h.shape[-1]).sum(-1).mean(-1) / (h.shape[-1] / 2)
    np.testing.assert_allclose(power.numpy(), 1.0, atol=0.1)
    hc = torch.complex(h[..., :1024], h[..., 1024:]).reshape(3, 3, -1, 64, 16)
    fewer = 0
    for s, paths in enumerate((3, 8, 16)):
        ranks = torch.linalg.matrix_rank(hc[s, :, :40], rtol=1e-5)
        assert fewer < int(ranks.max()) <= paths, (s, ranks)
        fewer = paths
    loader = tds.DMLGridLoader(data, 80, "train")
    idx = torch.as_tensor(tds._epoch_perms(cfg, loader.n, 0, 0, False))[:, :, :200].contiguous()
    for snr in (5.0, 10.0, 15.0):
        b = data.batch(idx, snr)
        nmse = float(((b["h_label"] - b["h_perf"]) ** 2).sum() / (b["h_perf"] ** 2).sum())
        np.testing.assert_allclose(10 * np.log10(nmse), 10 * np.log10(1.9) - snr, atol=0.15)
    x = data.rows["pilots"][0, 0, :4]
    hp = data.rows["h_perf"][0, 0, :4]
    pil = tch.clean_pilots(
        tch.CArr(hp[:, :1024], hp[:, 1024:]).reshape(4, 64, 16), data.geom
    )
    np.testing.assert_allclose(x.numpy(), torch.cat([pil.re, pil.im], -1).numpy(), atol=1e-6)
