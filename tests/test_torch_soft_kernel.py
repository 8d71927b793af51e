"""csrc/xpbd.cu, the kernel of the soft substep (physics/soft.py), and the
host-side tables it reads.

On the CPU (no kernel runs here), on the icosphere stand-in (the soft_body
scene, envs/soft_body.py) and on the pedestals scene (three icospheres over
a sphere, two capsules, a hull and three boxes):
  * each vertex's entries in `inc_start`/`inc_slot` are the plain version's
    gather rows (`incidence`) in their order, once for both constraints, and
    a correction buffer in the kernel's layout summed through them gives the
    plain gather's sums;
  * `vert_order` is a permutation by descending valence, and `vert_inst`
    gives each vertex the plain version's damping;
  * the packed constants are the plain version's own (Dm^-1, the corners'
    inverse masses, the relaxed Jacobi scale, the colliders, the hull planes);
  * both scenes' shared-memory layouts fit XPBD_MAX_SHARED_BYTES, and the
    wrapper raises ValueError on a mesh past it before it looks at anything
    else; a CPU tensor takes the plain loop.
The `cuda` tests, which run only where a CUDA device is (`python -m pytest -q
-m cuda tests/test_torch_soft_kernel.py` on the card), hold the kernel to the
plain version on the same CUDA tensors. KERNEL_TOL is the relative tolerance,
of the largest position, for the positions and for the velocities as metres
a substep (v h): the two order their sums differently (the kernel left to
right, PyTorch's reductions in trees) and PyTorch's `cross` and `@` contract
multiplies and adds into FMAs, which the kernel (built with -fmad=false) does
not; a velocity is its substep's displacement over h, so the positions'
last-bit rounding comes back 1/h larger in it. This file imports no JAX
package: tests/test_torch_soft.py holds the plain version to the JAX one.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from test_isaacgym_tpu_torch.envs import soft_body as sb
from test_isaacgym_tpu_torch.ops import _kernels
from test_isaacgym_tpu_torch.physics import soft

KERNEL_TOL = 1e-5
SUBSTEP_ITERS = 8  # the substep tests' iteration budget (the scenes' is 80)
COLLIDER_KINDS = {"sphere": 0, "capsule": 2, "hull": 3, "box": 1}  # SHAPE_* codes
COLLIDERS = ["ground"] + list(COLLIDER_KINDS)


# ---------------------------------------------------------------------------
# the substep's inputs (tests/test_torch_soft.py's too)

def alone(world, m):
    """The world with collider m alone (m None: no collider)."""
    keep = slice(0, 0) if m is None else slice(m, m + 1)
    return dataclasses.replace(world, col_shape=world.col_shape[keep],
                               col_body=world.col_body[keep], col_kind=world.col_kind[keep],
                               col_planes=world.col_planes[keep])


def deformed_state(world, centre, seed):
    """soft_pos: every instance's rest ball shrunk to 0.8, centred on
    `centre` and jittered by 0.05 m; soft_vel random (N(0, 0.5))."""
    rng = np.random.RandomState(seed)
    pos = np.empty((1, world.num_verts, 3), np.float32)
    for inst in world.instances:
        v = world.verts0[inst.vert_start:inst.vert_start + inst.vert_count]
        pos[0, inst.vert_start:inst.vert_start + inst.vert_count] = (
            0.8 * (v - v.mean(0)) + centre)
    pos += rng.normal(0, 0.05, pos.shape).astype(np.float32)
    return pos, rng.normal(0, 0.5, pos.shape).astype(np.float32)


def box_tie(pos, cp, half):
    """Move vertex 0 to where the box's |rel| - half ties exactly in x and z
    and is the largest (inside): argmax takes the first."""
    z = np.float32(cp[2] + 0.9)
    qz = np.abs(z - cp[2]) - half[2]
    for x in (np.float32(cp[0] + qz + half[0]), np.float32(cp[0] - qz - half[0])):
        if np.abs(x - cp[0]) - half[0] == qz:
            pos[0, 0] = (x, cp[1], z)
            q = np.abs(pos[0, 0] - cp) - half
            assert q[0] == q[2] == q.max() < 0, q
            return pos
    raise AssertionError("no exact tie found")


def substep_inputs(world, body_pos, shape_pos, shape_size, collider):
    """(the pedestals world with `collider` alone, soft_pos, soft_vel) of a
    substep test: every ball deformed over the collider's top ("ground": no
    collider, the balls straddling the ground's margin), and for the box
    vertex 0 on an exact argmax tie. The arrays are the scene's (1, ...)
    body positions and shape positions and sizes, numpy."""
    m = None if collider == "ground" else int(
        np.nonzero(world.col_kind == COLLIDER_KINDS[collider])[0][0])
    if m is None:
        centre = np.array([0.0, 0.0, 0.55], np.float32)
    else:
        body, shape = int(world.col_body[m]), int(world.col_shape[m])
        centre = (body_pos[0, body] + shape_pos[0, shape] + [0.0, 0.0, 0.6]).astype(np.float32)
    pos, vel = deformed_state(world, centre, seed=len(collider))
    if collider == "box":
        cp = (body_pos[0, body] + shape_pos[0, shape]).astype(np.float32)
        half = (shape_size[0, shape] + np.float32(world.thickness)).astype(np.float32)
        pos = box_tie(pos, cp, half)
    return alone(world, m), pos, vel


def replicated(world, copies):
    """The world's soft bodies `copies` times over in one env: a mesh as
    large as the caller needs."""
    V, T, S = world.num_verts, world.num_tets, len(world.tris)
    n_inst = len(world.instances)
    cat = lambda a, step=0: np.concatenate([a + c * step for c in range(copies)])  # noqa: E731
    return dataclasses.replace(
        world, verts0=cat(world.verts0), tets=cat(world.tets, V), inv_dm=cat(world.inv_dm),
        rest_vol=cat(world.rest_vol), inv_mass=cat(world.inv_mass),
        vert_tet_count=cat(world.vert_tet_count), tet_jacobi_scale=cat(world.tet_jacobi_scale),
        tris=cat(world.tris, V), tri_parent=cat(world.tri_parent, T),
        inst_of_tet=cat(world.inst_of_tet, n_inst),
        instances=[dataclasses.replace(i, vert_start=i.vert_start + c * V,
                                       tet_start=i.tet_start + c * T, tri_start=i.tri_start + c * S)
                   for c in range(copies) for i in world.instances])


def scene(name, device="cpu", envs=2):
    return sb.soft_body_sim(envs, device=device) if name == "soft_body" else sb.pedestals_sim(device)


def _args(sim, state=None):
    s = sim.state if state is None else state
    return (s.soft_pos, s.soft_vel, s.body_pos, s.body_quat, sim.params, sim.stepper.h,
            sim.params.gravity)


# ---------------------------------------------------------------------------
# the tables, on the CPU

SCENES = ["soft_body", "pedestals"]


@pytest.mark.parametrize("name", SCENES)
def test_incidence_tables_sum_as_the_plain_gather(name):
    """Each vertex's kernel entries, read once for the deviatoric and once
    for the hydrostatic corrections, are the plain gather's row in its
    order; summed through them, a random correction buffer in the kernel's
    (constraint, corner, axis, tet) layout gives the plain gather's sums."""
    st = scene(name).stepper.soft
    w, x = st.world, st.xpbd
    T, V = w.num_tets, w.num_verts
    start, slot = x.inc_start.numpy(), x.inc_slot.numpy()
    rows = st.gather_dx.view(V, -1).numpy()
    for v in range(V):
        s = slot[start[v]:start[v + 1]]
        k, t = s // (3 * T), s % (3 * T)
        assert (t < T).all()
        plain = rows[v][rows[v] < 8 * T]
        np.testing.assert_array_equal(np.concatenate([4 * t + k, 4 * T + 4 * t + k]), plain)
    assert start[-1] == len(slot) == 4 * T
    rng = np.random.RandomState(1)
    contrib = rng.normal(size=(2, T, 4, 3))  # (constraint, tet, corner, axis)
    plain = np.concatenate([contrib.reshape(8 * T, 3), np.zeros((1, 3))])[rows].sum(1)
    corr = contrib.transpose(0, 2, 3, 1).reshape(-1)  # the kernel's layout
    got = np.zeros((V, 3))
    for v in range(V):
        for c in range(2):
            for b in slot[start[v]:start[v + 1]]:
                got[v] += corr[12 * T * c + b + T * np.arange(3)]
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", SCENES)
def test_vertex_order_and_instances_give_the_plain_damping(name):
    """vert_order visits every vertex once, by descending valence; the
    damping each vertex takes through vert_inst is the plain version's max
    over its tets' instances."""
    sim = scene(name)
    st, w = sim.stepper.soft, sim.scene.soft
    order, inst = st.xpbd.vert_order.numpy(), st.xpbd.vert_inst.numpy()
    assert sorted(order.tolist()) == list(range(w.num_verts))
    valence = np.diff(st.xpbd.inc_start.numpy())
    assert (np.diff(valence[order]) <= 0).all()
    np.testing.assert_array_equal(valence, np.bincount(w.tets.ravel(), minlength=w.num_verts))
    N, I = 3, len(w.instances)
    dmp = torch.as_tensor(np.random.RandomState(2).uniform(-0.1, 0.5, (N, I)).astype(np.float32))
    per_tet = dmp[:, st.inst]
    corners = torch.cat([per_tet[..., None].expand(N, w.num_tets, 4).reshape(N, -1),
                         torch.zeros((N, 1))], 1)
    plain = torch.clamp(corners[:, st.gather_corner].amax(-1), min=0.0)
    assert (inst >= 0).all()
    kernel = torch.clamp(dmp[:, torch.as_tensor(inst, dtype=torch.int64)], min=0.0)
    assert torch.equal(kernel, plain)


@pytest.mark.parametrize("name", SCENES)
def test_packed_constants_are_the_plain_versions(name):
    """The mesh's and the colliders' constants the kernel reads are the
    tensors the plain iteration reads, bit for bit."""
    st = scene(name).stepper.soft
    w, x = st.world, st.xpbd
    T = w.num_tets
    np.testing.assert_array_equal(x.tets.numpy(), w.tets)
    assert torch.equal(x.inv_dm.view(T, 3, 3), st.inv_dm)
    assert torch.equal(x.w4, st.w4[..., 0]) and torch.equal(x.jac, st.jac_scale)
    np.testing.assert_array_equal(x.col.numpy(), np.stack([w.col_body, w.col_shape, w.col_kind], -1))
    assert torch.equal(x.col_quat, st.col_quat)
    assert x.planes.shape == (len(w.col_kind), w.col_planes.shape[1], 8)
    for c in st.colliders:
        p = x.planes[c.mi]
        if c.kind != 3:
            assert not p.any()
            continue
        assert torch.equal(p[:, :3], c.n_t.T) and torch.equal(p[:, 3], c.d)
        assert torch.equal(p[:, 4], c.margin_n) and torch.equal(p[:, 5], c.rows[:, 3])
        assert not p[:, 6:].any()
    for t in x:
        assert t.is_contiguous() and t.dtype in (torch.int32, torch.float32)


def test_layout_fits_both_scenes_and_a_larger_mesh_raises():
    """Both scenes fit the kernel's shared memory (the icosphere three blocks
    an SM); a world of four pedestals scenes does not, and the wrapper
    raises ValueError naming the limit before it checks any tensor."""
    sizes = {}
    for name in SCENES:
        w = scene(name).scene.soft
        sizes[name] = soft.xpbd_shared_bytes(w.num_verts, w.num_tets, len(w.col_kind))
    assert sizes == {"soft_body": 68500, "pedestals": 205660}
    assert 3 * (sizes["soft_body"] + 1024) <= 233472  # an SM's 228 KB, 1 KB reserved a block
    assert sizes["pedestals"] <= soft.XPBD_MAX_SHARED_BYTES
    sim = scene("pedestals")
    big = soft.SoftStepper(replicated(sim.scene.soft, 4), sim.scene, "cpu")
    assert soft.xpbd_shared_bytes(4 * 585, 4 * 1710, 7) > soft.XPBD_MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="XPBD_MAX_SHARED_BYTES = 232448"):
        big._substep_cuda(*_args(sim))


def test_cpu_tensors_take_the_plain_loop(monkeypatch):
    """On CPU tensors `substep` is `_substep_torch`, the loop of `iterate`,
    and never the kernel's wrapper."""
    sim = scene("soft_body")
    st = sim.stepper.soft
    calls = []
    iterate = st.iterate
    monkeypatch.setattr(st, "iterate", lambda *a: calls.append(1) or iterate(*a))
    monkeypatch.setattr(st, "_substep_cuda", lambda *a: pytest.fail("the kernel's wrapper ran"))
    before = _kernels.launches["xpbd"]
    got = st.substep(*_args(sim))
    assert len(calls) == st.iters == 80
    monkeypatch.setattr(st, "iterate", iterate)
    for a, b in zip(got, st._substep_torch(*_args(sim))):
        assert torch.equal(a, b)
    assert _kernels.launches["xpbd"] == before


# ---------------------------------------------------------------------------
# the kernel against the plain version, on the card

def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def close_substep(got, want, h, what):
    """Positions, and velocities as metres a substep, within KERNEL_TOL of
    the largest position."""
    scale = float(want[0].abs().max())
    for name, g, w, unit in (("pos", got[0], want[0], 1.0), ("vel", got[1], want[1], h)):
        assert g.shape == w.shape and g.dtype == torch.float32 and g.is_cuda
        assert torch.isfinite(g).all(), f"{what} {name}"
        err = float((g - w).abs().max()) * unit
        assert err <= KERNEL_TOL * scale, f"{what} {name}: {err:.3e} > {KERNEL_TOL} * {scale:.3g}"


@pytest.fixture(scope="module")
def pedestals_cuda():
    _needs_cuda()
    return sb.pedestals_sim("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [SUBSTEP_ITERS, 80])
@pytest.mark.parametrize("collider", COLLIDERS)
def test_kernel_matches_plain_on_cuda(pedestals_cuda, collider, iters):
    """One substep of the pedestals balls over each collider alone (the
    ground alone for "ground"; the box with vertex 0 on an argmax tie),
    kernel against plain on the same CUDA tensors; one launch a substep."""
    sim = pedestals_cuda
    p = sim.params
    world, pos, vel = substep_inputs(sim.scene.soft, sim.state.body_pos.cpu().numpy(),
                                     p.shape_pos.cpu().numpy(), p.shape_size.cpu().numpy(),
                                     collider)
    st = soft.SoftStepper(world, sim.scene, "cuda")
    st.iters, st.has_ground = iters, collider == "ground"
    args = (torch.as_tensor(pos, device="cuda"), torch.as_tensor(vel, device="cuda"),
            sim.state.body_pos, sim.state.body_quat, p, sim.stepper.h, p.gravity)
    before = _kernels.launches["xpbd"]
    got = st.substep(*args)
    assert _kernels.launches["xpbd"] == before + 1
    want = st._substep_torch(*args)
    torch.cuda.synchronize()
    close_substep(got, want, sim.stepper.h, f"{collider} at {iters} iterations")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_kernel_matches_plain_on_the_scenes_on_cuda(name):
    """Each whole scene (the soft_body scene at 64 envs, 20 steps into its
    drop; the pedestals with its seven colliders, 10 steps in), one substep
    of its own at 80 iterations, kernel against plain."""
    _needs_cuda()
    sim = scene(name, "cuda", envs=64)
    state = sim.stepper.rollout(sim.state, sim.actions, sim.params, 20 if name == "soft_body" else 10)
    st = sim.stepper.soft
    got = st.substep(*_args(sim, state))
    want = st._substep_torch(*_args(sim, state))
    torch.cuda.synchronize()
    close_substep(got, want, sim.stepper.h, name)


@pytest.mark.cuda
def test_kernel_is_bitwise_repeatable():
    """Two launches on the same inputs give the same bits."""
    _needs_cuda()
    sim = scene("soft_body", "cuda", envs=256)
    st = sim.stepper.soft
    for a, b in zip(st.substep(*_args(sim)), st.substep(*_args(sim))):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    """An oversize mesh, a float64 state and one that requires grad raise
    ValueError on the card with nothing launched; the icosphere's blocks fit
    at least two an SM."""
    _needs_cuda()
    sim = scene("pedestals", "cuda")
    before = _kernels.launches["xpbd"]
    big = soft.SoftStepper(replicated(sim.scene.soft, 4), sim.scene, "cuda")
    with pytest.raises(ValueError, match="XPBD_MAX_SHARED_BYTES"):
        big.substep(*_args(sim))
    st, args = sim.stepper.soft, list(_args(sim))
    with pytest.raises(ValueError, match="float32"):
        st.substep(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="requires grad"):
        st.substep(args[0].clone().requires_grad_(True), *args[1:])
    assert _kernels.launches["xpbd"] == before
    blocks_per_sm = _kernels.entry("xpbd", "xpbd_blocks_per_sm", [ctypes.c_int] * 3)
    assert blocks_per_sm(195, 570, 1) >= 2


@pytest.mark.cuda
def test_a_step_launches_the_kernel_once_a_substep_sync_free():
    """A soft_body step on the card (3 substeps) launches the kernel 3
    times, with host syncs made errors."""
    _needs_cuda()
    sim = scene("soft_body", "cuda", envs=64)
    one = lambda s: sim.stepper.rollout(s, sim.actions, sim.params, 1)  # noqa: E731
    state = one(sim.state)  # warm: allocator, library and handles
    torch.cuda.synchronize()
    before = _kernels.launches["xpbd"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = one(state)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _kernels.launches["xpbd"] == before + sim.stepper.substeps == before + 3
    assert torch.isfinite(state.soft_pos).all()
