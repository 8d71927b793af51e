"""Port parity: the torch sphere-world solve against the JAX package's.

`_torch_solve` (test_isaacgym_tpu_torch/ops/sphere_world.py) is held against
`_jnp_solve` on the analytic cases of tests/test_sphere_world.py and on
random batches, fed the same numpy inputs. Tolerance: 1e-5 of the largest
magnitude of each output (float32, same formula, sums in another order).

The Hopper kernel itself is compared with `_torch_solve`, on random worlds
and on a dense one, and shown to repeat bitwise, by the `cuda` tests at the
end, which run only where a CUDA device is present. The packing of its allow
mask and its size limit are host code, tested here on the CPU.
"""
import numpy as np
import pytest
import torch

from chip_smoke import dense_cube
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
    assert spec.to("cpu") is spec
    assert spec.allow_bits is None and spec.row_start is None and spec.entries == 0


def _unpack(bits, F):
    """(F, F) bool of pack_allow's words (bit l of word w = column 32 w + l)."""
    b = np.ascontiguousarray(bits).view(np.uint8)
    return np.unpackbits(b, axis=1, bitorder="little")[:, :F].astype(bool)


@pytest.mark.parametrize("F", [1, 31, 32, 33, 96])
def test_pack_allow_round_trips(F):
    """The kernel's bit-packed mask unpacks to allow | allow^T, and row_start
    counts each row's allowed pairs (random upper-triangular mask)."""
    rng = np.random.RandomState(F)
    allow = np.triu(rng.uniform(size=(F, F)) < 0.4, 1)
    bits, row_start = tsw.pack_allow(allow)
    assert bits.dtype == np.uint32 and bits.shape == (F, -(-F // 32))
    sym = allow | allow.T
    np.testing.assert_array_equal(_unpack(bits, F), sym)
    # no bit past column F - 1
    assert not np.unpackbits(bits.view(np.uint8), axis=1, bitorder="little")[:, F:].any()
    assert row_start.dtype == np.int32 and row_start.shape == (F + 1,)
    np.testing.assert_array_equal(np.diff(row_start), sym.sum(1))
    assert row_start[0] == 0 and row_start[-1] == 2 * allow.sum()


def test_kernel_refuses_more_spheres_than_its_limit():
    """Above MAX_SPHERES the wrapper raises by name, before touching the spec
    or the device."""
    F = tsw.MAX_SPHERES + 1
    z3, z1 = torch.zeros(1, F, 3), torch.zeros(1, F)
    with pytest.raises(ValueError, match="MAX_SPHERES = 32768"):
        tsw._cuda_solve(None, z3, z3, z3, z1, z1, z1, z1, z1,
                        1 / 60, 9, 0.01, 0.0025, 0.2)


@pytest.mark.parametrize("N,F", [(1, 1), (1, 96), (2, 1080)])
def test_scratch_layout_holds_every_allowed_pair(N, F):
    """The kernel's scratch: aligned parts, none overlapping, 10 bytes an
    allowed ordered pair. With every pair allowed it stays within 1.3x of the
    two dense (N, F, F) f32 impulse matrices it replaced."""
    entries = F * (F - 1)
    at_rows, at_lams, at_nbs, total = tsw.scratch_layout(N, F, entries)
    assert at_rows >= 4 * N * F and at_lams >= at_rows + 56 * N * F
    assert at_nbs == at_lams + 8 * N * entries and total >= at_nbs + 2 * N * entries
    assert all(x % 16 == 0 for x in (at_rows, at_lams, at_nbs, total))
    assert total - 60 * N * F <= 10 * N * entries + 48
    assert total <= 1.3 * 8 * N * F * F + 60 * N * F + 48


def test_dense_cube_is_dense():
    """The dense world of chip_smoke.py and the `cuda` tests: its live pairs
    (numpy count) are ~30x the pile's and up to 96 a sphere."""
    pos, _, _, r = dense_cube()[:4]
    d = np.linalg.norm(pos[0, :, None] - pos[0, None], axis=-1)
    live = np.triu(r[0, :, None] + r[0, None] - d > -0.01, 1)
    assert int(live.sum()) == 30410
    assert int((live | live.T).sum(1).max()) == 96


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """Hopper kernel vs the plain version on the card: 1e-5 of the largest
    magnitude, for N=1 and N=2 random worlds with and without ground."""
    _needs_cuda()
    for N, ground in ((1, True), (2, True), (2, False)):
        args = [torch.as_tensor(x, device="cuda") for x in _random_args(3, N=N, F=96)]
        spec = _spec(tsw, 96, ground=ground)
        before = _kernels.launches["sphere_world"]
        got = tsw.solve(spec.to("cuda"), *args, 1 / 120, 8, 0.01, 0.0025, 0.2)
        assert _kernels.launches["sphere_world"] == before + tsw.LAUNCHES_PER_SOLVE
        want = tsw._torch_solve(spec, *args, 1 / 120, 8, 0.01, 0.0025, 0.2)
        torch.cuda.synchronize()
        _assert_close([w.cpu().numpy() for w in want], [g.cpu().numpy() for g in got])


@pytest.mark.cuda
def test_kernel_matches_plain_on_dense_world():
    """The dense world's live lists do not fit in shared memory, so the
    kernel takes its device-memory path: still 1e-5 of the largest magnitude."""
    _needs_cuda()
    args = [torch.as_tensor(x, device="cuda") for x in dense_cube()]
    spec = _spec(tsw, 1080)
    got = tsw.solve(spec.to("cuda"), *args, 1 / 60, 9, 0.01, 0.0025, 0.2)
    want = tsw._torch_solve(spec, *args, 1 / 60, 9, 0.01, 0.0025, 0.2)
    torch.cuda.synchronize()
    _assert_close([w.cpu().numpy() for w in want], [g.cpu().numpy() for g in got])


@pytest.mark.cuda
def test_kernel_matches_plain_at_its_sphere_limit():
    """MAX_SPHERES spheres in 2048 far-apart groups of 16, pairs allowed
    within a group: the broadphase takes 16 tiles, each thread of the sweeps
    owns several rows, and rows and lists spill to device memory. Each group
    must match the plain version solving it alone (1e-5 of the largest
    magnitude)."""
    _needs_cuda()
    G, K = 2048, 16
    F = G * K
    assert F == tsw.MAX_SPHERES
    groups = _random_args(11, N=G, F=K)
    pos = groups[0].copy()
    pos[:, :, 0] += 5.0 * (np.arange(G) % 64)[:, None]
    pos[:, :, 1] += 5.0 * (np.arange(G) // 64)[:, None]
    allow = np.zeros((F, F), bool)
    block = np.triu(np.ones((K, K), bool), 1)
    for g in range(G):
        allow[g * K:(g + 1) * K, g * K:(g + 1) * K] = block
    world = [torch.as_tensor(x.reshape((1, F) + x.shape[2:]), device="cuda")
             for x in (pos, *groups[1:])]
    got = tsw.solve(_spec(tsw, F, allow=allow).to("cuda"), *world,
                    1 / 60, 9, 0.01, 0.0025, 0.2)
    want = tsw._torch_solve(_spec(tsw, K), *[torch.as_tensor(x, device="cuda")
                                            for x in (pos, *groups[1:])],
                            1 / 60, 9, 0.01, 0.0025, 0.2)
    torch.cuda.synchronize()
    _assert_close([w.cpu().numpy() for w in want],
                  [g.reshape(G, K, 3).cpu().numpy() for g in got])
    assert np.abs(want[2].cpu().numpy()).max() > 0  # the groups collide


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["random", "dense"])
def test_kernel_is_bitwise_repeatable(world):
    """Two solves of the same inputs give the same bits."""
    _needs_cuda()
    if world == "random":
        F, args = 96, _random_args(3, N=2, F=96)
    else:
        F, args = 1080, dense_cube()
    args = [torch.as_tensor(x, device="cuda") for x in args]
    spec = _spec(tsw, F).to("cuda")
    a = tsw.solve(spec, *args, 1 / 60, 9, 0.01, 0.0025, 0.2)
    b = tsw.solve(spec, *args, 1 / 60, 9, 0.01, 0.0025, 0.2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_kernel_refuses_scratch_larger_than_the_card():
    """A spec whose allowed pairs need more scratch than the card holds
    raises by name before anything is allocated or launched."""
    _needs_cuda()
    F = 96
    args = [torch.as_tensor(x, device="cuda") for x in _random_args(3, N=1, F=F)]
    spec = _spec(tsw, F).to("cuda")
    card = torch.cuda.get_device_properties(0).total_memory
    huge = spec._replace(entries=card // 10 + 1)
    before = _kernels.launches["sphere_world"]
    with pytest.raises(ValueError, match="bytes of scratch"):
        tsw.solve(huge, *args, 1 / 60, 9, 0.01, 0.0025, 0.2)
    assert _kernels.launches["sphere_world"] == before


@pytest.mark.cuda
def test_kernel_launches_on_its_tensors_card():
    """With card 0 current, a solve of tensors on the last card launches on
    that card (the library launches on the current device, so the wrapper
    makes the tensors' device current) and matches the plain version."""
    _needs_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    args = [torch.as_tensor(x, device=last) for x in _random_args(3, N=2, F=96)]
    spec = _spec(tsw, 96)
    before = _kernels.launches["sphere_world"]
    got = tsw.solve(spec.to(last), *args, 1 / 120, 8, 0.01, 0.0025, 0.2)
    assert _kernels.launches["sphere_world"] == before + tsw.LAUNCHES_PER_SOLVE
    want = tsw._torch_solve(spec, *args, 1 / 120, 8, 0.01, 0.0025, 0.2)
    torch.cuda.synchronize(last)
    assert torch.cuda.current_device() == 0
    assert all(g.device == last for g in got)
    _assert_close([w.cpu().numpy() for w in want], [g.cpu().numpy() for g in got])
