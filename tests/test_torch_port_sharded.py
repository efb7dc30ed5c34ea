"""The port's sharded statevector (``qdml_tpu_torch/quantum/sharded.py``) against the JAX package's.

- The per-shard gate functions, in one process: each RY/RZ on a global wire
  and the four CNOT cases (control and target each global or local), over
  K = 2, 4, 8 shards of a random state, reassembled and held against the
  port's full-state gates; the whole circuit run shard by shard in one
  process against JAX's ``run_circuit(..., "tensor")``.
- gloo worlds of 2 and 4 ranks (one world each, both cases in it) at n=6,
  L=2 and n=10, L=1: ⟨Z⟩ and the gradients of ``sum(<Z>^2)`` against JAX's
  ``run_circuit_sharded`` on a 2- and a 4-device model mesh of the same
  inputs, at JAX's tolerances (``tests/test_parallel.py:35-62``: rtol 1e-4
  / atol 1e-5 for values, rtol 1e-3 / atol 1e-5 for gradients). Inputs
  reach the ranks as ``.pt`` files; the ranks import no JAX.
- The k = 0 hand-over to ``tensor`` and the error for a model axis that is
  not a power of two.

Their twins on ``cuda:0`` over host-staged gloo are in
``test_torch_port_multirank_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from qdml_tpu.quantum.circuits import run_circuit as jrun_circuit  # noqa: E402
from qdml_tpu.quantum.sharded import run_circuit_sharded as jrun_sharded  # noqa: E402
from qdml_tpu_torch.config import MeshConfig  # noqa: E402
from qdml_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from qdml_tpu_torch.parallel.selfcheck import read_ranks, spawn_world  # noqa: E402
from qdml_tpu_torch.quantum import sharded as tsh  # noqa: E402
from qdml_tpu_torch.quantum import statevector as sv  # noqa: E402
from qdml_tpu_torch.quantum.circuits import run_circuit  # noqa: E402
from qdml_tpu_torch.quantum.kernels import rotation_layer_plain  # noqa: E402
from qdml_tpu_torch.utils.complexops import CArr  # noqa: E402

CASES = ((6, 2, 5), (10, 1, 3))  # (n, L, batch)


def _inputs(n, layers, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (batch, n)).astype(np.float32),
            rng.uniform(-3, 3, (layers, n, 2)).astype(np.float32))


def _state(n, batch, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((batch, 2**n)) + 1j * rng.standard_normal((batch, 2**n))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return CArr(torch.tensor(z.real, dtype=torch.float32), torch.tensor(z.imag, dtype=torch.float32))


def _split(psi, k):
    size = psi.re.shape[-1] >> k
    return [CArr(psi.re[:, i * size:(i + 1) * size], psi.im[:, i * size:(i + 1) * size]) for i in range(2**k)]


def _join(shards):
    return CArr(torch.cat([s.re for s in shards], -1), torch.cat([s.im for s in shards], -1))


def _close(a, b, tol=1e-6):
    torch.testing.assert_close(a.re, b.re, atol=tol, rtol=0)
    torch.testing.assert_close(a.im, b.im, atol=tol, rtol=0)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_global_rotations_match_the_full_state_gates(k):
    n, batch = 5, 3
    psi = _state(n, batch, k)
    shards = _split(psi, k)
    theta = torch.tensor([0.3, -1.1, 2.0])
    for q in range(k):
        bits = [tsh.rank_bits(i, k) for i in range(2**k)]
        ry = [tsh.ry_global(shards[i], shards[tsh.partner(i, k, q)], theta, bits[i][q]) for i in range(2**k)]
        _close(_join(ry), sv.apply_ry(psi, n, q, theta))
        rz = [tsh.rz_global(shards[i], torch.tensor(0.7), bits[i][q]) for i in range(2**k)]
        _close(_join(rz), sv.apply_rz(psi, n, q, torch.tensor(0.7)))


@pytest.mark.parametrize(
    "k,case",
    [(k, c) for k in (1, 2, 3) for c in ("local-local", "global-local", "local-global", "global-global")
     if not (c == "global-global" and k < 2)],  # two global wires need k >= 2
)
def test_the_four_cnot_cases_match_the_full_state_gate(k, case):
    n, batch = 5, 2
    control, target = {
        "local-local": (k, n - 1), "global-local": (k - 1, k + 1),
        "local-global": (n - 1, 0), "global-global": (0, k - 1),
    }[case]
    psi = _state(n, batch, 10 + k)
    shards = _split(psi, k)
    out = []
    for i in range(2**k):
        other = shards[tsh.partner(i, k, target)] if target < k else None
        out.append(tsh.cnot_sharded(shards[i], other, k, n - k, control, target, tsh.rank_bits(i, k)))
    _close(_join(out), sv.apply_cnot(psi, n, control, target))


def _emulated(angles, weights, n, layers, k):
    """run_circuit_sharded's gate sequence, every shard in this process."""
    nl = n - k
    bits = [tsh.rank_bits(i, k) for i in range(2**k)]
    psi = [tsh.product_state_shard(angles, nl, b) for b in bits]
    for l in range(layers):
        for q in range(k):
            psi = [tsh.ry_global(psi[i], psi[tsh.partner(i, k, q)], weights[l, q, 0], bits[i][q]) for i in range(2**k)]
            psi = [tsh.rz_global(p, weights[l, q, 1], b[q]) for p, b in zip(psi, bits)]
        psi = [rotation_layer_plain(p.re, p.im, weights[l, k:], nl) for p in psi]
        for c in range(n - 1):
            psi = [tsh.cnot_sharded(psi[i], psi[tsh.partner(i, k, c + 1)] if c + 1 < k else None, k, nl, c, c + 1, bits[i])
                   for i in range(2**k)]
        psi = [tsh.cnot_sharded(psi[i], psi[tsh.partner(i, k, 0)], k, nl, n - 1, 0, bits[i]) for i in range(2**k)]
    return sum(tsh.expvals_z_local(p, nl, b) for p, b in zip(psi, bits))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_shard_by_shard_circuit_matches_jax_tensor(k):
    n, layers = 6, 2
    a, w = _inputs(n, layers, 4, k)
    got = _emulated(torch.tensor(a), torch.tensor(w), n, layers, k)
    want = np.asarray(jrun_circuit(jnp.asarray(a), jnp.asarray(w), n, layers, "tensor"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def _jax_sharded(a, w, n, layers, k_devices):
    mesh = JMesh(np.array(jax.devices()[:k_devices]), ("model",))

    def loss(a, w):
        out = jrun_sharded(a, w, n, layers, mesh)
        return jnp.sum(out**2), out

    (_, out), (ga, gw) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(jnp.asarray(a), jnp.asarray(w))
    return np.asarray(out), np.asarray(ga), np.asarray(gw)


def _run_world(tmp, k_devices, device="cpu", env=None, reps=0, cases=CASES):
    inp, out = tmp / "in", tmp / "out"
    inp.mkdir(parents=True)
    payload = []
    for n, layers, batch in cases:
        a, w = _inputs(n, layers, batch, n + layers)
        payload.append({"n": n, "layers": layers, "angles": torch.tensor(a), "weights": torch.tensor(w)})
    torch.save({"cases": payload, "reps": reps}, inp / "circuit.pt")
    rcs = spawn_world(
        k_devices, ["-m", "qdml_tpu_torch.parallel.selfcheck", "circuit", f"--in={inp}", f"--out={out}",
                    f"--device={device}"], tmp / "logs", env=env, timeout_s=120,
    )
    assert rcs == [0] * k_devices, [(tmp / "logs" / f"rank{r}.log").read_text()[-2000:] for r in range(k_devices)]
    return [r["steps"][0] for r in read_ranks(out, k_devices)]


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    return request.param, _run_world(tmp_path_factory.mktemp(f"sharded{request.param}"), request.param)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sharded_world_matches_jax_sharded(world, case):
    k_devices, ranks = world
    n, layers, batch = CASES[case]
    a, w = _inputs(n, layers, batch, n + layers)
    want, ga, gw = _jax_sharded(a, w, n, layers, k_devices)
    for r in ranks:
        got = r["cases"][case]
        assert got["shard_amplitudes"] == 2**n // k_devices
        np.testing.assert_allclose(got["ev"], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["g_angles"], ga, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(got["g_weights"], gw, rtol=1e-3, atol=1e-5)
        # CPU tensors: the plain version, which counts no launch
        assert got["rotation_layer_launches_per_forward"] == 0


def test_one_rank_hands_over_to_tensor_and_odd_axes_raise():
    n, layers = 6, 2
    a, w = (torch.tensor(x) for x in _inputs(n, layers, 3, 0))
    got = tsh.run_circuit_sharded(a, w, n, layers)  # no world: a model line of one
    torch.testing.assert_close(got, run_circuit(a, w, n, layers, impl="tensor"))
    torch.testing.assert_close(run_circuit(a, w, n, layers, impl="sharded"), got)
    odd = make_mesh(MeshConfig(model_axis=3, data_axis=1), world=3, rank=0)
    with pytest.raises(ValueError, match="must be a power of two"):
        tsh.run_circuit_sharded(a, w, n, layers, odd)
