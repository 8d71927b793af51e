"""Port parity: quaternion, spatial and transform math and small SPD solves
against the JAX package.

Random float32 batches made with numpy go through both packages. Tolerance:
1e-5 of the largest magnitude of each result for quaternions and solves;
1e-6 absolute for math/spatial.py and math/transform.py on unit-scale
inputs (the port repeats the JAX package's operations in the same order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_isaacgym_tpu.math import quat as jq
from test_isaacgym_tpu.utils import linalg as jl
from test_isaacgym_tpu_torch.math import quat as tq
from test_isaacgym_tpu_torch.utils import linalg as tl

TOL = 1e-5
RNG = np.random.RandomState(0)
B = (64, 3)


def _q(shape=B):
    q = RNG.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _v(shape=B, k=3, s=1.0):
    return (RNG.normal(size=shape + (k,)) * s).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= TOL * scale


QUAT_CASES = {
    "quat_normalize": lambda: (_v(k=4),),
    "quat_conjugate": lambda: (_q(),),
    "quat_inverse": lambda: (_v(k=4),),
    "quat_mul": lambda: (_q(), _q()),
    "quat_rotate": lambda: (_q(), _v()),
    "quat_rotate_inverse": lambda: (_q(), _v()),
    "quat_from_angle_axis": lambda: (_v(k=1)[..., 0], _v()),
    "quat_to_angle_axis": lambda: (_q(),),
    "quat_from_euler_zyx": lambda: tuple(_v(k=1)[..., 0] for _ in range(3)),
    "quat_to_euler_zyx": lambda: (_q(),),
    "quat_to_matrix": lambda: (_q(),),
    "matrix_to_quat": lambda: (np.array(jq.quat_to_matrix(jnp.asarray(_q()))),),
    "quat_integrate": lambda: (_q(), _v(s=3.0), 1 / 60),
    "quat_exp_map": lambda: (_v(),),
    "quat_log_map": lambda: (_q(),),
    "orientation_error": lambda: (_q(), _q()),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quat_matches_jax(name):
    args = QUAT_CASES[name]()
    want = getattr(jq, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    got = getattr(tq, name)(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args])
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    else:
        _close(got.numpy(), want)


def test_quat_identity():
    _close(tq.quat_identity((5,), device="cpu").numpy(), jq.quat_identity((5,)))


def _close_abs(got, want, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= atol


def _ic():
    """Random symmetric positive definite (64, 3, 3, 3) inertias."""
    A = RNG.normal(size=B + (3, 3)) * 0.3
    return (A @ np.swapaxes(A, -1, -2) + 0.01 * np.eye(3)).astype(np.float32)


def _m():
    return RNG.uniform(0.2, 2.0, size=B).astype(np.float32)


SPATIAL_CASES = {
    "cross_motion": lambda: (_v(k=6), _v(k=6)),
    "cross_force": lambda: (_v(k=6), _v(k=6)),
    "inertia_mul": lambda: (_m(), _v(s=0.3), _ic(), _v(k=6)),
    "dot": lambda: (_v(k=6), _v(k=6)),
    "inertia_params_add": lambda: ((_m(), _v(s=0.3), _ic()), (_m(), _v(s=0.3), _ic())),
    "mm3": lambda: (_v(k=9).reshape(B + (3, 3)), _v(k=9).reshape(B + (3, 3))),
    "sandwich3": lambda: (np.array(jq.quat_to_matrix(jnp.asarray(_q()))), _ic()),
    "skew": lambda: (_v(),),
    "motion_subspace_revolute": lambda: (_v(), _v()),
    "motion_subspace_prismatic": lambda: (_v(),),
    "point_velocity": lambda: (_v(k=6), _v()),
    "force_at_point": lambda: (_v(), _v(), _v()),
}
TRANSFORM_CASES = {
    "transform_apply": lambda: (_v(), _q(), _v()),
    "transform_vector": lambda: (_q(), _v()),
    "transform_mul": lambda: (_v(), _q(), _v(), _q()),
    "transform_inverse": lambda: (_v(), _q()),
}


def _convert(args, to):
    return tuple(_convert(a, to) if isinstance(a, tuple) else to(a) for a in args)


@pytest.mark.parametrize("module,name", [("spatial", n) for n in sorted(SPATIAL_CASES)]
                         + [("transform", n) for n in sorted(TRANSFORM_CASES)])
def test_spatial_and_transform_match_jax(module, name):
    """math/spatial.py and math/transform.py at 1e-6 absolute on random
    batches of unit-scale inputs."""
    import test_isaacgym_tpu.math as jm
    import test_isaacgym_tpu_torch.math as tm

    args = {**SPATIAL_CASES, **TRANSFORM_CASES}[name]()
    want = getattr(getattr(jm, module), name)(*_convert(args, jnp.asarray))
    got = getattr(getattr(tm, module), name)(*_convert(args, torch.as_tensor))
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close_abs(g.numpy(), w)
    else:
        _close_abs(got.numpy(), want)


def test_transform_identity_and_exports():
    import test_isaacgym_tpu.math as jm
    import test_isaacgym_tpu_torch.math as tm

    for g, w in zip(tm.transform_identity((4,), device="cpu"), jm.transform_identity((4,))):
        _close_abs(g.numpy(), w)
    for name in dir(jm):
        if not name.startswith("_"):
            assert hasattr(tm, name), name


def test_cross_broadcasts_like_jnp():
    a, b = _v(), _v(shape=(3,))
    _close_abs(tq.cross(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
               np.cross(a, b))


def _spd(n, batch=(32,)):
    M = RNG.normal(size=batch + (n, n))
    return (M @ np.swapaxes(M, -1, -2) + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n", range(3, 10))
def test_spd_solve_matches_jax(n):
    A = _spd(n)
    b = RNG.normal(size=(32, n)).astype(np.float32)
    Bm = RNG.normal(size=(32, n, 6)).astype(np.float32)
    _close(tl.spd_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy(),
           jl.spd_solve(jnp.asarray(A), jnp.asarray(b)))
    _close(tl.spd_solve(torch.as_tensor(A), torch.as_tensor(Bm)).numpy(),
           jl.spd_solve(jnp.asarray(A), jnp.asarray(Bm)))


@pytest.mark.parametrize("n", range(3, 10))
def test_spd_inv_and_binv_match_jax(n):
    A = _spd(n, batch=(4, 8))
    want = np.asarray(jl.spd_inv(jnp.asarray(A)))
    _close(tl.spd_inv(torch.as_tensor(A)).numpy(), want)
    _close(tl.binv(torch.as_tensor(A)).numpy(), np.asarray(jl.binv(jnp.asarray(A))))
    # and it is an inverse
    eye = np.broadcast_to(np.eye(n, dtype=np.float32), A.shape)
    np.testing.assert_allclose(A @ tl.spd_inv(torch.as_tensor(A)).numpy(), eye, atol=1e-4)
