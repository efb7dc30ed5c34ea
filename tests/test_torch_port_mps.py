"""The port's bond-chi MPS circuit impl and the qubit-scaling axis against the
JAX package's, on the CPU.

- ``mps_circuit`` against JAX's ``mps_circuit`` on the same seeded inputs,
  values and angle/weight gradients, at n = 4..10 and chi from 2 to full:
  values within 2e-5, gradients within 5e-4 of the largest at full chi and
  5e-3 at a truncating one, whose backward divides by the kept/discarded
  gap in float32 (measured: values 1.1e-5; gradients 1e-6 of the largest
  at full chi, up to 2.1e-3 over 16 seeded truncating cases).
  Single sites are never compared: LAPACK's and torch's SVDs choose other
  gauges, and the circuit's <Z> and gradients are gauge-invariant (the
  port takes each SVD in complex128, JAX in complex64). One truncating
  setting is left out because the two frameworks keep different states
  there: chi = 8 at n = 8 (L = 3) and n = 10 (L = 2) differs by 0.1-0.19 in
  every seed tried, each 0.09-0.24 from dense, while chi = 2, 4 and 16 agree
  to 1.6e-5. The split keeps ``min(chi, rows, cols)`` columns, zero
  singular values included, and each SVD library completes those columns
  its own way; the scheme truncates without bringing the rest of the chain
  to canonical form, so a later local spectrum can depend on that
  completion (ROADMAP section C). The truncation error still falls with chi
  (tested below).
- At full chi against the port's ``dense`` (JAX's
  ``test_mps_values_match_dense_at_full_chi`` and ``test_mps_grads_match_
  dense`` tolerances, 1e-5 and 2e-4); the truncation error does not grow
  with chi; ``chi < 2`` raises; bfloat16 angles give float32; all-zero
  angles and weights (exactly degenerate spectra) give finite gradients.
- ``trunc_split``'s projector backward: ``gradcheck`` in complex128 of the
  gauge-invariant outputs ``left @ right`` and ``left @ left^H`` on random
  tall, square and wide blocks.
- Dispatch: ``eligible_impls`` / ``impl_eligible`` against JAX's
  ``eligible_impls(n, "gpu", 1)`` over the scaling grid, ``auto`` resolving
  ``mps`` at n = 16, the race recording ``mps_chi``, and QuantumNAT's noise
  stream unchanged under ``mps``.
- The scaling axis: ``QUBIT_SCALING_GRID``, ``scaling_batch``,
  ``scaling_chi`` and ``impl_agreement``'s choice of reference against
  JAX's on a one-device topology.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu.eval import sweep as jsweep  # noqa: E402
from qdml_tpu.quantum import autotune as jat  # noqa: E402
from qdml_tpu.quantum import circuits as jcirc  # noqa: E402
from qdml_tpu.quantum.mps import mps_circuit as jmps  # noqa: E402
from qdml_tpu_torch.eval import sweep as tsweep  # noqa: E402
from qdml_tpu_torch.models.qsc import QSCP128  # noqa: E402
from qdml_tpu_torch.quantum import autotune as tat  # noqa: E402
from qdml_tpu_torch.quantum import circuits as tcirc  # noqa: E402
from qdml_tpu_torch.quantum import mps as tmps  # noqa: E402


def _inputs(n, layers, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, (batch, n)).astype(np.float32),
            rng.uniform(0, 2 * np.pi, (layers, n, 2)).astype(np.float32))


def _port_value_and_grads(a, w, n, layers, impl, chi=None):
    ta, tw = torch.tensor(a, requires_grad=True), torch.tensor(w, requires_grad=True)
    out = tcirc.run_circuit(ta, tw, n, layers, impl=impl, mps_chi=chi)
    (out**2).sum().backward()
    return out.detach().numpy(), tw.grad.numpy(), ta.grad.numpy()


def _full_chi(n):
    return 1 << (n // 2)


@pytest.mark.parametrize("n,layers,chi", [
    (4, 2, 2), (4, 2, 4), (6, 3, 2), (6, 3, 4), (6, 3, 8), (8, 2, 4), (8, 3, 16), (10, 3, 16), (10, 2, 32),
])
def test_mps_matches_jax_values_and_gradients(n, layers, chi):
    a, w = _inputs(n, layers, batch=3, seed=10 * n + chi)
    fn = jax.jit(jax.value_and_grad(lambda w, a: (jnp.sum(jmps(a, w, n, layers, chi) ** 2), jmps(a, w, n, layers, chi)),
                                    argnums=(0, 1), has_aux=True))
    (_, want), (gw_want, ga_want) = fn(jnp.asarray(w), jnp.asarray(a))
    got, gw, ga = _port_value_and_grads(a, w, n, layers, "mps", chi)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)
    # a truncating cut's backward divides by the kept/discarded gap in float32
    rel = 5e-4 if chi >= _full_chi(n) else 5e-3
    for g, gj in ((gw, gw_want), (ga, ga_want)):
        gj = np.asarray(gj)
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, gj, rtol=0, atol=rel * float(np.abs(gj).max()) + 1e-6)


@pytest.mark.parametrize("n,layers", [(4, 2), (6, 3), (8, 2)])
def test_mps_values_and_gradients_match_dense_at_full_chi(n, layers):
    a, w = _inputs(n, layers, batch=4, seed=n)
    got, gw, ga = _port_value_and_grads(a, w, n, layers, "mps", _full_chi(n))
    want, gw_d, ga_d = _port_value_and_grads(a, w, n, layers, "dense")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gw, gw_d, rtol=0, atol=2e-4)
    np.testing.assert_allclose(ga, ga_d, rtol=0, atol=2e-4)


def test_truncation_error_does_not_grow_with_chi():
    n, layers = 8, 3
    a, w = _inputs(n, layers, batch=3, seed=5)
    dense = tcirc.run_circuit(torch.tensor(a), torch.tensor(w), n, layers, impl="dense").numpy()
    errs = []
    for chi in (2, 4, 8, 16):
        out = tcirc.run_circuit(torch.tensor(a), torch.tensor(w), n, layers, impl="mps", mps_chi=chi).numpy()
        errs.append(float(np.abs(out - dense).max()))
    assert all(lo <= hi + 1e-7 for lo, hi in zip(errs[1:], errs[:-1])), errs
    assert errs[-1] <= 1e-5 and errs[0] > errs[-1], errs


def test_chi_below_two_raises_and_lead_shapes_round_trip():
    with pytest.raises(ValueError, match="mps_chi must be >= 2"):
        tcirc.run_circuit(torch.zeros(2, 4), torch.zeros(1, 4, 2), 4, 1, impl="mps", mps_chi=1)
    a, w = _inputs(5, 2, batch=6, seed=4)
    lead = tmps.mps_circuit(torch.tensor(a).reshape(2, 3, 5), torch.tensor(w), 5, 2, chi=4)
    assert lead.shape == (2, 3, 5)
    one = tmps.mps_circuit(torch.tensor(a[0]), torch.tensor(w), 5, 2, chi=4)
    assert one.shape == (5,)
    np.testing.assert_allclose(lead.reshape(6, 5)[0].numpy(), one.numpy(), atol=1e-6)


def test_bf16_angles_give_float32():
    n, layers = 6, 2
    a, w = _inputs(n, layers, batch=4, seed=3)
    dense = tcirc.run_circuit(torch.tensor(a), torch.tensor(w), n, layers, impl="dense").numpy()
    out = tcirc.run_circuit(torch.tensor(a).bfloat16(), torch.tensor(w).bfloat16(), n, layers, impl="mps",
                            mps_chi=_full_chi(n))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), dense, atol=3e-2)


def test_degenerate_spectra_give_finite_gradients():
    """All-zero angles and weights: the state stays |0...0>, every split has
    one nonzero singular value and exactly degenerate zeros, where torch's
    own SVD backward would divide by zero."""
    n, layers = 6, 2
    got, gw, ga = _port_value_and_grads(np.zeros((3, n), np.float32), np.zeros((layers, n, 2), np.float32),
                                        n, layers, "mps", 4)
    want, gw_d, ga_d = _port_value_and_grads(np.zeros((3, n), np.float32), np.zeros((layers, n, 2), np.float32),
                                             n, layers, "dense")
    assert np.all(np.isfinite(gw)) and np.all(np.isfinite(ga))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(gw, gw_d, atol=1e-5)
    np.testing.assert_allclose(ga, ga_d, atol=1e-5)


@pytest.mark.parametrize("shape,k", [((6, 4), 2), ((4, 4), 2), ((4, 6), 3), ((2, 8, 4), 3)])
def test_trunc_split_backward_passes_gradcheck(shape, k):
    gen = torch.Generator().manual_seed(sum(shape) + k)
    theta = torch.complex(torch.randn(shape, generator=gen, dtype=torch.float64),
                          torch.randn(shape, generator=gen, dtype=torch.float64)).requires_grad_(True)

    def invariant(t):
        left, right = tmps.trunc_split(t, k)
        return left @ right, left @ left.mH

    assert torch.autograd.gradcheck(invariant, (theta,), eps=1e-6, atol=1e-5, rtol=1e-4)


GRID = (4, 6, 8, 10, 12, 14, 16, 20, 24)


@pytest.mark.parametrize("n", GRID)
def test_eligibility_matches_jax_single_device(n):
    want = list(jat.eligible_impls(n, "gpu", 1))
    if 2 <= n <= 6:  # the port's circuit kernel runs below JAX's 128-lane floor
        want.insert(want.index("pallas") + 1, "pallas_circuit")
    assert tat.eligible_impls(n) == want
    assert ("mps" in want) == (n >= 13)
    for impl in ("dense", "pallas", "pallas_circuit", "tensor", "mps"):
        assert tat.impl_eligible(impl, n)[0] == jat.impl_eligible(impl, n, 1)[0], (impl, n)
    ok, why = tat.impl_eligible("sharded_statevector", n)
    assert not ok and "A.10" in why
    assert tat.UNPORTED_IMPLS == ("sharded_statevector",)


def test_auto_resolves_mps_at_16_qubits_and_the_race_records_chi(tmp_path):
    a, w = _inputs(16, 1, batch=2, seed=16)
    out = tcirc.run_circuit(torch.tensor(a), torch.tensor(w), 16, 1, impl="auto", backend="auto")
    assert tcirc.resolve_impl("auto", "auto", 16, 1, 2, platform="cpu") == "mps"
    want = tcirc.run_circuit(torch.tensor(a), torch.tensor(w), 16, 1, impl="mps", mps_chi=tmps.DEFAULT_CHI)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert jcirc.resolve_backend("auto", 16) == "mps"
    path = str(tmp_path / "t.json")
    entry = tat.ensure(13, 1, 2, path=path, budget_s=0.01, device="cpu", mps_chi=4)
    assert set(entry["candidates"]) == {"tensor", "mps"} and entry["mps_chi"] == 4
    assert all("train_ms" in c for c in entry["candidates"].values())
    # an entry without mps (written before the impl existed) reads the same
    old = tat.ensure(4, 1, 2, path=path, budget_s=0.01, device="cpu")
    assert "mps_chi" not in old
    tat.invalidate_cache()
    assert tat.lookup(4, 1, 2, path=path, platform="cpu") == old["best_train"]
    assert tat.lookup(13, 1, 2, path=path, platform="cpu") == entry["best_train"]
    tat.invalidate_cache()


def test_quantumnat_noise_stream_is_the_same_under_mps():
    x = torch.tensor(np.random.default_rng(9).standard_normal((3, 2, 16, 8)).astype(np.float32))
    outs = {}
    for impl in ("dense", "mps"):
        torch.manual_seed(0)
        m = QSCP128(4, 2, use_quantumnat=True, noise_level=0.3, impl=impl, mps_chi=_full_chi(4))
        m.train()
        outs[impl] = m(x, train=True, generator=torch.Generator().manual_seed(11)).detach()
    torch.testing.assert_close(outs["mps"], outs["dense"], rtol=1e-4, atol=1e-5)


def _stub(monkeypatch):
    """Both packages' run_circuit replaced by zeros: only the choice of
    reference is compared."""
    monkeypatch.setattr(jcirc, "run_circuit", lambda a, w, n, *args, **kw: jnp.zeros(a.shape))
    monkeypatch.setattr(tcirc, "run_circuit", lambda a, w, n, *args, **kw: torch.zeros(a.shape))
    monkeypatch.setattr(jat, "model_axis_devices", lambda: 1)  # JAX on one device


def test_scaling_helpers_and_reference_choice_match_jax(monkeypatch):
    assert tsweep.QUBIT_SCALING_GRID == jsweep.QUBIT_SCALING_GRID == GRID
    for n in GRID:
        assert tsweep.scaling_batch(n) == jsweep.scaling_batch(n)
        for chi in (1, 2, 8, 16, 64, 10**6):
            assert tsweep.scaling_chi(n, chi) == jsweep.scaling_chi(n, chi)
    _stub(monkeypatch)
    for n in GRID:
        for impl in tat.eligible_impls(n):
            got = tsweep.impl_agreement(n, impl, batch=2, device="cpu")
            want = jsweep.impl_agreement(n, impl, batch=2)
            assert got["reference"] == want["reference"], (n, impl)
            assert (got["max_abs_delta"] is None) == (want["max_abs_delta"] is None)
    assert tsweep.impl_agreement(16, "mps", device="cpu") == {"reference": None, "max_abs_delta": None}


def test_impl_agreement_measures_the_winner_against_its_reference():
    got = tsweep.impl_agreement(6, "pallas_circuit", device="cpu")
    assert got["reference"] == "dense" and got["max_abs_delta"] <= 1e-5
    got = tsweep.impl_agreement(13, "tensor", n_layers=1, batch=2, mps_chi=64, device="cpu")
    assert got["reference"] == "mps" and got["max_abs_delta"] <= 1e-5
