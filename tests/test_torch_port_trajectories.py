"""The port's trajectory simulator and ``QSCP128``'s depolarizing mode
against the JAX package's, on the CPU.

The JAX package draws its Pauli outcomes with ``jax.random.choice`` from
keys no torch generator reproduces, so the test recomputes JAX's outcome
indices from the same keys (``split(key, n_traj)``, then ``split(k, L + 1)``
per trajectory, one ``choice`` per noise site) and feeds them to the port:
<Z> then agrees with ``run_circuit_trajectories`` to 1e-5 (float32 gate
chains and the trajectory mean in another order). ``p = 0`` reproduces the
clean circuit, ``p`` outside [0, 1] and nan are refused, the one-wire
anchor <Z> -> (1 - 4p/3) <Z> holds within its Monte-Carlo band for the
port's own draws, and ``QSCP128`` keeps the JAX impl-precedence check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu.models.qsc import QSCP128 as JQSC  # noqa: E402
from qdml_tpu.quantum import trajectories as jtraj  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.models.qsc import QSCP128  # noqa: E402
from qdml_tpu_torch.quantum import circuits as tcirc  # noqa: E402
from qdml_tpu_torch.quantum import trajectories as ttraj  # noqa: E402


def _jax_outcomes(key, p, lead, n, n_layers, n_traj):
    probs = jnp.array([1.0 - p, p / 3.0, p / 3.0, p / 3.0], jnp.float32)
    out = []
    for k in jax.random.split(key, n_traj):
        keys = jax.random.split(k, n_layers + 1)
        out.append([np.asarray(jax.random.choice(keys[s], 4, lead + (n,), p=probs)) for s in range(n_layers + 1)])
    return torch.from_numpy(np.array(out)).long()


@pytest.mark.parametrize("n,n_layers,p", [(2, 1, 0.3), (4, 2, 0.1), (5, 3, 0.6)])
def test_trajectories_match_jax_with_its_draws(n, n_layers, p):
    rng = np.random.default_rng(n)
    angles = rng.uniform(-1, 1, (6, n)).astype(np.float32)
    weights = rng.uniform(0, 2 * np.pi, (n_layers, n, 2)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jtraj.run_circuit_trajectories(angles, weights, n, n_layers, p, key, 8))
    r = _jax_outcomes(key, p, (6,), n, n_layers, 8)
    assert (r > 0).any()  # some noise was drawn
    got = ttraj.run_circuit_trajectories(torch.from_numpy(angles), torch.from_numpy(weights), n, n_layers, p,
                                         n_traj=8, outcomes=r)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_p0_is_the_clean_circuit():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 4)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0, 2 * np.pi, (2, 4, 2)).astype(np.float32))
    got = ttraj.run_circuit_trajectories(a, w, 4, 2, 0.0, torch.Generator().manual_seed(0), n_traj=3)
    want = tcirc.run_circuit(a, w, 4, 2, impl="tensor")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert got.shape == (2, 3, 4)


@pytest.mark.parametrize("p", [-0.1, 1.5, float("nan")])
def test_check_p_rejects_outside_the_unit_interval(p):
    with pytest.raises(ValueError, match="in \\[0, 1\\]"):
        ttraj._check_p(p)
    with pytest.raises(ValueError):
        ttraj.run_circuit_trajectories(torch.zeros(1, 2), torch.zeros(1, 2, 2), 2, 1, p, torch.Generator())
    with pytest.raises(ValueError):
        jtraj._check_p(p)  # the JAX package refuses the same values


def test_outcome_draws_follow_the_depolarizing_distribution():
    gen = torch.Generator().manual_seed(3)
    r = ttraj.draw_outcomes(gen, (200000,), 0.3)
    freq = np.bincount(r.numpy(), minlength=4) / r.numel()
    np.testing.assert_allclose(freq, [0.7, 0.1, 0.1, 0.1], atol=5 * np.sqrt(0.25 / r.numel()))
    assert (ttraj.draw_outcomes(gen, (1000,), 0.0) == 0).all()
    assert (ttraj.draw_outcomes(gen, (1000,), 1.0) > 0).all()


@pytest.mark.parametrize("p", [0.15, 0.6])
def test_one_wire_anchor_within_its_monte_carlo_band(p):
    """One twirl on a real one-wire state (the ring needs two wires, so the
    twirl is applied to the embedded state directly): <Z> -> (1 - 4p/3) <Z>."""
    b, n_traj = 400, 64
    angles = torch.linspace(-1.2, 1.2, b)[:, None]
    clean = torch.cos(angles[:, 0])
    psi = tcirc.angle_embed(ttraj.sv.zero_state(1, (n_traj, b), device="cpu"), angles.expand(n_traj, b, 1), 1)
    r = ttraj.draw_outcomes(torch.Generator().manual_seed(4), (n_traj, b, 1), p)
    z = ttraj.sv.expvals_z(ttraj.apply_random_paulis(psi, r, 1), 1)[..., 0].mean(0)
    ratio = float((z * clean).sum() / (clean * clean).sum())
    band = 5.0 / np.sqrt(b * n_traj) / float(clean.abs().mean())
    assert abs(ratio - (1 - 4 * p / 3)) < band, (ratio, 1 - 4 * p / 3, band)


def test_qsc_depolarizing_precedence_and_jax_forward(monkeypatch):
    import qdml_tpu.models.qsc as jqsc_mod

    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 16, 8, 2)).astype(np.float32)
    jm = JQSC(n_qubits=4, n_layers=2, depolarizing_p=0.2, n_trajectories=4)
    key = jax.random.PRNGKey(0)
    params = jax.device_get(JQSC(n_qubits=4, n_layers=2).init(key, x, train=False))["params"]
    # the key the module derives from its "trajectories" stream (make_rng)
    seen = {}

    def spy(*args):
        seen["key"] = args[5]
        return jtraj.run_circuit_trajectories(*args)

    monkeypatch.setattr(jqsc_mod, "run_circuit_trajectories", spy)
    want = np.asarray(jm.apply({"params": params}, x, rngs={"trajectories": jax.random.PRNGKey(9)}))
    model = QSCP128(4, 2, depolarizing_p=0.2, n_trajectories=4)
    model.load_state_dict(interop.qsc_state_dict_from_flax(params))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    tkey = jax.random.PRNGKey(9)
    r = _jax_outcomes(seen["key"], 0.2, (3,), 4, 2, 4)
    # the model's own trajectory call, with JAX's outcomes in place of a draw
    angles = model.preprocess(xt)
    expz = ttraj.run_circuit_trajectories(angles, model.qlayer.weights, 4, 2, 0.2, n_traj=4, outcomes=r)
    got = torch.log_softmax(model.classifier(expz), dim=-1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    out = model(xt, traj_generator=torch.Generator().manual_seed(0))
    assert out.shape == (3, 3) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="traj_generator"):
        model(xt)
    for backend, impl in (("dense", "auto"), ("auto", "pallas_circuit"), ("tensor", "dense")):
        with pytest.raises(ValueError, match="tensor formulation only"):
            QSCP128(4, 2, backend=backend, impl=impl, depolarizing_p=0.2)(xt, traj_generator=torch.Generator())
        with pytest.raises(ValueError, match="tensor formulation only"):
            JQSC(n_qubits=4, n_layers=2, backend=backend, impl=impl, depolarizing_p=0.2).apply(
                {"params": params}, x, rngs={"trajectories": tkey})
    for backend, impl in (("tensor", "auto"), ("dense", "tensor"), ("auto", "auto")):
        QSCP128(4, 2, backend=backend, impl=impl, depolarizing_p=0.2)(xt, traj_generator=torch.Generator())
