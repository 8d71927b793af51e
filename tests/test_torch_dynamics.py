"""Port parity: articulated dynamics against both forms of the JAX package.

The port keeps only the dense masked CRBA/RNEA. `link_world_inertia`,
`motion_subspaces`, `crba`, `rnea_bias`, `forward_dynamics` and
`mass_matrix` are held against the JAX package's dense form and its
composite-unrolled form (TIG_DYNAMICS_FORM=unrolled, called without jit) on
the same numpy inputs: the link states of a random configuration (FK of the
JAX package), random applied torques, implicit damping and external link
wrenches, for the pendulum, the branched chain and the Panda stand-in with a
fixed and a floating base (test_torch_kinematics.py). Tolerance:
1e-5 * max(|ref|, 1) of each output. The port's mass matrix is also checked
symmetric positive definite.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_isaacgym_tpu.physics import dynamics as jd
from test_isaacgym_tpu.physics import kinematics as jk
from test_isaacgym_tpu_torch.physics import dynamics as td
from test_torch_kinematics import CASES, JAX, PORT, close, random_state, topo_of

G = np.array([0.0, 0.0, -9.8], np.float32)


def _inputs(jtopo, seed):
    """numpy link states (pos, quat, lin, ang), qd, tau, d_eff, f_ext and
    per-link body params."""
    rp, rq, rl, ra, q, qd = random_state(jtopo, seed)
    if jtopo.fixed_base:
        rl, ra = rl * 0, ra * 0
    links = [np.array(x) for x in jk.fk(jtopo, *(jnp.asarray(a) for a in (rp, rq, rl, ra, q, qd)))]
    rng = np.random.RandomState(seed + 100)
    B, L = q.shape[0], jtopo.num_links
    nv = jtopo.num_dofs + (0 if jtopo.fixed_base else 6)
    extra = dict(
        tau=rng.normal(size=(B, nv)),
        d_eff=rng.uniform(0.0, 50.0, (B, nv)),
        f_ext=rng.normal(size=(B, L, 6)),
        mass=np.asarray(jtopo.mass) * rng.uniform(0.8, 1.2, (B, L)),
        com=np.asarray(jtopo.com) + rng.uniform(-0.01, 0.01, (B, L, 3)),
        inertia=np.asarray(jtopo.inertia) * rng.uniform(0.8, 1.2, (B, L, 1, 1)),
    )
    return links, qd, {k: np.asarray(v, np.float32) for k, v in extra.items()}


def _run(dyn, topo, links, qd, extra, conv):
    """Every function under test, in package `dyn`, on converted inputs."""
    pos, quat, lin, ang = (conv(x) for x in links)
    qd, g = conv(qd), conv(G)
    tau, d_eff, f_ext = (conv(extra[k]) for k in ("tau", "d_eff", "f_ext"))
    body = {k: conv(extra[k]) for k in ("mass", "com", "inertia")}
    origin = pos[..., 0, :]
    m, com_w, ic_w = dyn.link_world_inertia(topo, quat, **body)
    com_rel = (pos - origin[..., None, :]) + com_w
    S = dyn.motion_subspaces(topo, pos, quat, origin)
    vel_sp = dyn.spatial_velocities(topo, pos, lin, ang, origin)
    qdd, M, A = dyn.forward_dynamics(
        topo, pos, quat, lin, ang, qd, tau, 1 / 120, d_eff, g,
        f_ext=f_ext, return_op=True, **body,
    )
    return dict(
        m=m, com_w=com_w, ic_w=ic_w, S=S, vel_sp=vel_sp,
        crba=dyn.crba(topo, S, m, com_rel, ic_w),
        rnea=dyn.rnea_bias(topo, S, m, com_rel, ic_w, vel_sp, qd, g),
        rnea_fext=dyn.rnea_bias(topo, S, m, com_rel, ic_w, vel_sp, qd, g, f_ext),
        qdd=qdd, M=M, A=A,
        mass_matrix=dyn.mass_matrix(topo, pos, quat, **body),
        mass_matrix_default=dyn.mass_matrix(topo, pos, quat),
    )


@pytest.mark.parametrize("form", ["dense", "unrolled"])
@pytest.mark.parametrize("name,fixed", CASES)
def test_dynamics_matches_jax_form(name, fixed, form, monkeypatch):
    monkeypatch.setenv("TIG_DYNAMICS_FORM", form)
    jtopo, ttopo = topo_of(JAX, name, fixed), topo_of(PORT, name, fixed)
    links, qd, extra = _inputs(jtopo, seed=3 + len(name) + 7 * fixed)
    want = _run(jd, jtopo, links, qd, extra, jnp.asarray)
    got = _run(td, ttopo, links, qd, extra, torch.as_tensor)
    assert set(got) == set(want)
    for k in want:
        close(got[k].numpy(), want[k], f"{k} ({form})")


@pytest.mark.parametrize("name,fixed", CASES)
def test_mass_matrix_is_spd(name, fixed):
    ttopo = topo_of(PORT, name, fixed)
    links, _, extra = _inputs(topo_of(JAX, name, fixed), seed=11)
    pos, quat = torch.as_tensor(links[0]), torch.as_tensor(links[1])
    M = td.mass_matrix(ttopo, pos, quat).double().numpy()
    np.testing.assert_allclose(M, np.swapaxes(M, -1, -2), atol=1e-5 * max(np.abs(M).max(), 1))
    assert np.linalg.eigvalsh(M).min() > 0


@pytest.mark.parametrize("name,fixed", CASES)
def test_forward_dynamics_base_wrench_matches_jax(name, fixed):
    """A world [torque; force] wrench on the base, about the root: added to
    a floating base's rows, ignored for a fixed one (JAX dynamics.py:372,
    :392-394)."""
    jtopo, ttopo = topo_of(JAX, name, fixed), topo_of(PORT, name, fixed)
    links, qd, extra = _inputs(jtopo, seed=5 + len(name) + 7 * fixed)
    wrench = np.random.RandomState(9).normal(size=(qd.shape[0], 6)).astype(np.float32) * 5

    def run(dyn, topo, conv, w):
        pos, quat, lin, ang = (conv(x) for x in links)
        body = {k: conv(extra[k]) for k in ("mass", "com", "inertia")}
        return dyn.forward_dynamics(
            topo, pos, quat, lin, ang, conv(qd), conv(extra["tau"]), 1 / 120,
            conv(extra["d_eff"]), conv(G), f_ext=conv(extra["f_ext"]),
            base_wrench=None if w is None else conv(w), **body,
        )[0]

    want = np.asarray(run(jd, jtopo, jnp.asarray, wrench))
    got = run(td, ttopo, torch.as_tensor, wrench).numpy()
    close(got, want, f"qdd with a base wrench ({name}, fixed={fixed})")
    free = run(td, ttopo, torch.as_tensor, None).numpy()
    assert np.array_equal(got, free) == fixed  # a floating base feels it
