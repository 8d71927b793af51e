"""Port parity: the torch sphere-world solve against the JAX package's.

`_torch_solve` (test_isaacgym_tpu_torch/ops/sphere_world.py) is held against
`_jnp_solve` on the analytic cases of tests/test_sphere_world.py and on
random batches, fed the same numpy inputs. Tolerance: 1e-5 of the largest
magnitude of each output (float32, same formula, sums in another order).

The Hopper kernel itself is compared with `_torch_solve` by the `cuda` test
at the end, which runs only where a CUDA device is present.
"""
import numpy as np
import pytest
import torch

from test_isaacgym_tpu.ops import sphere_world as jsw
from test_isaacgym_tpu_torch.ops import _kernels
from test_isaacgym_tpu_torch.ops import sphere_world as tsw

TOL = 1e-5


def _spec(mod, F, allow=None, ground=True, plane_friction=1.0):
    if allow is None:
        allow = np.triu(np.ones((F, F), bool), 1)
    return mod.SphereWorldSpec(
        shape_idx=np.arange(F, dtype=np.int32),
        free_idx=np.arange(F, dtype=np.int32),
        body_slot=np.arange(F, dtype=np.int32),
        allow=allow,
        has_ground=ground,
        plane_n=np.array([0, 0, 1], np.float32),
        plane_d=0.0,
        plane_friction=plane_friction,
        plane_restitution=0.0,
    )


def _ball_args(pos, vel, omega=None, r=0.2, density=500.0, mu=0.8, rest=0.0):
    """numpy (pos, vel, omega, radius, inv_m, inv_i, mu, rest), N=1."""
    pos = np.asarray(pos, np.float32)[None]
    vel = np.asarray(vel, np.float32)[None]
    F = pos.shape[1]
    omega = np.zeros_like(pos) if omega is None else np.asarray(omega, np.float32)[None]
    m = 4 / 3 * np.pi * r**3 * density
    full = lambda x: np.full((1, F), x, np.float32)  # noqa: E731
    return (pos, vel, omega, full(r), full(1.0 / m), full(1.0 / (0.4 * m * r * r)),
            full(mu), full(rest))


def _random_args(seed, N, F):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, (N, F, 3)).astype(np.float32)
    pos[..., 2] = rng.uniform(0.1, 1.0, (N, F))
    vel = rng.uniform(-1, 1, (N, F, 3)).astype(np.float32)
    omega = rng.uniform(-3, 3, (N, F, 3)).astype(np.float32)
    r = rng.uniform(0.1, 0.25, (N, F)).astype(np.float32)
    m = (4 / 3 * np.pi * r**3 * 500.0).astype(np.float32)
    inv_m = (1.0 / m).astype(np.float32)
    inv_i = (1.0 / (0.4 * m * r * r)).astype(np.float32)
    mu = rng.uniform(0.3, 1.0, (N, F)).astype(np.float32)
    rest = rng.uniform(0.0, 0.8, (N, F)).astype(np.float32)
    return (pos, vel, omega, r, inv_m, inv_i, mu, rest)


def _both(spec_args, args, h, iters, co=0.01, slop=0.0025, bt=0.2):
    """Run the JAX and the torch plain versions on the same numpy inputs."""
    import jax.numpy as jnp

    a = jsw._jnp_solve(_spec(jsw, *spec_args[0], **spec_args[1]),
                       *[jnp.asarray(x) for x in args], h, iters, co, slop, bt)
    b = tsw.solve(_spec(tsw, *spec_args[0], **spec_args[1]),
                  *[torch.as_tensor(x) for x in args], h, iters, co, slop, bt)
    return [np.asarray(x) for x in a], [y.numpy() for y in b]


def _assert_close(a, b, tol=TOL):
    for name, x, y in zip(("vel", "omega", "cf"), a, b):
        assert x.shape == y.shape, name
        scale = max(float(np.abs(x).max()), 1.0)
        err = float(np.abs(x - y).max())
        assert err <= tol * scale, f"{name}: max |err| {err:.3e} > {tol} * {scale:.3g}"


ANALYTIC = {
    # head-on pair in free space (momentum, depenetration bias)
    "head_on": (((2,), dict(ground=False)),
                _ball_args([[-0.19, 0, 1.0], [0.19, 0, 1.0]], [[1.0, 0, 0], [-1.0, 0, 0]]),
                1 / 120, 12),
    # restitution 0.8 bounce
    "restitution": (((2,), dict(ground=False)),
                    _ball_args([[-0.195, 0, 1.0], [0.195, 0, 1.0]],
                               [[1.0, 0, 0], [-1.0, 0, 0]], rest=0.8),
                    1 / 120, 20),
    # resting on the ground plane
    "ground_support": (((1,), {}),
                       _ball_args([[0, 0, 0.2 - 0.003]], [[0, 0, -9.8 / 120]]),
                       1 / 120, 12),
    # filtered pair passes through untouched
    "allow_mask": (((2,), dict(allow=np.zeros((2, 2), bool), ground=False)),
                   _ball_args([[-0.1, 0, 1.0], [0.1, 0, 1.0]], [[1.0, 0, 0], [-1.0, 0, 0]]),
                   1 / 120, 8),
}


@pytest.mark.parametrize("case", sorted(ANALYTIC))
def test_analytic_cases_match_jax(case):
    spec_args, args, h, iters = ANALYTIC[case]
    a, b = _both(spec_args, args, h, iters)
    _assert_close(a, b)


def test_analytic_physics_hold_in_port():
    """The analytic expectations of tests/test_sphere_world.py, on the port."""
    spec_args, args, h, iters = ANALYTIC["head_on"]
    _, (v, _, cf) = _both(spec_args, args, h, iters)
    assert abs(v[0, 0, 0] + v[0, 1, 0]) < 1e-4  # momentum
    assert -0.05 < v[0, 1, 0] - v[0, 0, 0] < 0.6
    assert cf[0, 0, 0] < 0 and cf[0, 1, 0] > 0
    spec_args, args, h, iters = ANALYTIC["restitution"]
    _, (v, _, _) = _both(spec_args, args, h, iters)
    assert 1.2 < v[0, 1, 0] - v[0, 0, 0] < 1.8
    spec_args, args, h, iters = ANALYTIC["ground_support"]
    _, (v, _, cf) = _both(spec_args, args, h, iters)
    assert abs(v[0, 0, 2]) < 2e-2 and cf[0, 0, 2] > 0
    spec_args, args, h, iters = ANALYTIC["allow_mask"]
    _, (v, _, cf) = _both(spec_args, args, h, iters)
    np.testing.assert_allclose(v, args[1], atol=1e-6)
    assert np.abs(cf).max() == 0.0


@pytest.mark.parametrize("ground", [True, False])
def test_random_batch_matches_jax(ground):
    """F=96, N=2 random worlds (the shape of test_pallas_matches_jnp)."""
    args = _random_args(3, N=2, F=96)
    a, b = _both(((96,), dict(ground=ground)), args, 1 / 120, 8)
    _assert_close(a, b)
    # the random worlds really collide
    assert np.abs(a[2]).max() > 0


def test_cpu_solve_launches_no_kernel():
    """CPU tensors take the plain version: the kernel's count stays 0."""
    _kernels.launches.clear()
    args = _random_args(5, N=1, F=16)
    tsw.solve(_spec(tsw, 16), *[torch.as_tensor(x) for x in args],
              1 / 60, 9, 0.01, 0.0025, 0.2)
    assert _kernels.launches["sphere_world"] == 0


def test_spec_to_cpu_keeps_no_device_mask():
    spec = _spec(tsw, 8)
    assert spec.to("cpu") is spec and spec.allow_dev is None


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """Hopper kernel vs the plain version on the card: 1e-5 of the largest
    magnitude, for N=1 and N=2 random worlds with and without ground."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for N, ground in ((1, True), (2, True), (2, False)):
        args = [torch.as_tensor(x, device="cuda") for x in _random_args(3, N=N, F=96)]
        spec = _spec(tsw, 96, ground=ground)
        before = _kernels.launches["sphere_world"]
        got = tsw.solve(spec.to("cuda"), *args, 1 / 120, 8, 0.01, 0.0025, 0.2)
        assert _kernels.launches["sphere_world"] == before + 8
        want = tsw._torch_solve(spec, *args, 1 / 120, 8, 0.01, 0.0025, 0.2)
        torch.cuda.synchronize()
        _assert_close([w.cpu().numpy() for w in want], [g.cpu().numpy() for g in got])
