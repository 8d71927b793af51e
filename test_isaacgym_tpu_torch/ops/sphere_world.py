"""All-pairs sphere-world contacts: the large-free-body fast path.

Port of test_isaacgym_tpu/ops/sphere_world.py. Worlds dominated by free
sphere actors (the reference's examples/1080_balls_of_solitude.py — 1080
balls in one collision world under --all_collisions) skip the sparse
contact table: every candidate pair is evaluated as a dense (F, F) tile,
with sphere-sphere narrowphase, restitution targets and a mass-split
relaxed-Jacobi impulse solve with accumulated normal/friction impulses.
Ground-plane contacts ride along per sphere.

Two implementations of one function:
  * `_cuda_solve`, the wrapper of the hand-written Hopper kernel
    csrc/sphere_world.cu (the port of the Pallas TPU kernel
    `_pallas_solve` / `_sw_kernel`), for CUDA tensors: a broadphase launch
    that lists each sphere's live contacts once, then one launch that runs
    every Jacobi sweep on those lists; at most MAX_SPHERES spheres a world;
  * `_torch_solve`, the plain PyTorch version, line for line the JAX
    package's `_jnp_solve`, for CPU tensors and as the kernel's reference.
`solve` picks by the tensors' device alone: no switch, no fallback.

Conventions match physics/contacts.py: normal points b->a (j->i), Baumgarte
beta=0.2, slop = rest_offset + 1.5e-3, speculative targets below the slop
depth, PhysX AVERAGE material combine.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _kernels

# free sphere actors a world needs before it takes the dense path (the JAX
# package's routing: below it the static contact table is cheaper)
MIN_SPHERES = 64
# spheres a world may hold on CUDA tensors: the kernel keeps the velocities
# of a world in the shared memory of one 8-block cluster (kMaxF in
# csrc/sphere_world.cu). Its device-memory scratch grows with the allowed
# pairs (`scratch_layout`) and must fit in the card's memory too.
MAX_SPHERES = 32768
# launches of the kernel per solve: the broadphase, then all the sweeps
LAUNCHES_PER_SOLVE = 2


def pack_allow(allow: np.ndarray):
    """The kernel's form of an (F, F) allow mask: the symmetric mask
    allow | allow^T bit-packed as (F, ceil(F / 32)) uint32 words (bit l of
    word w of row i is pair (i, 32 w + l)), and row_start (F + 1,) int32,
    the offsets of each row's allowed pairs in a list of all of them
    (row_start[F] entries in all)."""
    sym = np.asarray(allow, bool)
    sym = sym | sym.T
    F = sym.shape[0]
    words = -(-F // 32)
    padded = np.zeros((F, 32 * words), bool)
    padded[:, :F] = sym
    bits = np.packbits(padded, axis=1, bitorder="little").view("<u4")
    row_start = np.zeros(F + 1, np.int64)
    np.cumsum(sym.sum(1), out=row_start[1:])
    return bits.reshape(F, words), row_start.astype(np.int32)


class SphereWorldSpec(NamedTuple):
    """Static description of the sphere world of one env."""

    shape_idx: np.ndarray  # (F,) env shape indices of the spheres
    free_idx: np.ndarray  # (F,) indices into the free-body batch
    body_slot: np.ndarray  # (F,) env body slots (for contact-force output)
    allow: np.ndarray  # (F, F) bool, upper-triangular collidable pairs
    has_ground: bool  # plane contacts handled here (no heightfield)
    plane_n: np.ndarray  # (3,)
    plane_d: float
    plane_friction: float
    plane_restitution: float
    # `pack_allow(allow)` on a CUDA device, for the kernel: bits as int32
    # (F, ceil(F / 32)), row_start (F + 1,) int32; set by `to(device)`,
    # which callers keep and reuse across solves
    allow_bits: Optional[torch.Tensor] = None
    row_start: Optional[torch.Tensor] = None
    entries: int = 0  # row_start[F]: allowed pairs, each counted by both rows

    def to(self, device) -> "SphereWorldSpec":
        """This spec with the kernel's packed `allow` uploaded to `device`
        (a no-op for the CPU, whose plain version reads `allow` itself)."""
        device = torch.device(device)
        if device.type != "cuda":
            return self
        bits, row_start = pack_allow(self.allow)
        return self._replace(
            allow_bits=torch.as_tensor(bits.view(np.int32), device=device),
            row_start=torch.as_tensor(row_start, device=device),
            entries=int(row_start[-1]),
        )


def build_spec(scene) -> Optional[SphereWorldSpec]:
    """Pick out the free sphere actors of `scene` if there are at least
    MIN_SPHERES of them. Returns None for small scenes (the static table is
    cheaper there)."""
    from ..core.scene import SHAPE_SPHERE

    fg = scene.free_group
    if fg is None:
        return None
    sh = scene.shapes
    rows = []
    for fi, b in enumerate(fg.body_slot):
        s = np.nonzero(sh.body_slot == b)[0]
        if len(s) == 1 and sh.kind[s[0]] == SHAPE_SPHERE:
            rows.append((int(s[0]), fi, int(b)))
    if len(rows) < MIN_SPHERES:
        return None
    shape_idx = np.array([r[0] for r in rows], np.int32)
    free_idx = np.array([r[1] for r in rows], np.int32)
    body_slot = np.array([r[2] for r in rows], np.int32)

    grp = sh.collision_group[shape_idx]
    flt = sh.collision_filter[shape_idx]
    gi, gj = grp[:, None], grp[None, :]
    allow = (gi == gj) | (gi == -1) | (gj == -1)
    allow &= (flt[:, None] & flt[None, :]) == 0
    allow &= np.triu(np.ones_like(allow), 1) > 0  # i < j once per pair

    has_ground = scene.ground is not None and scene.heightfield is None
    if has_ground:
        n = np.asarray(scene.ground.normal, np.float32)
        n = n / max(np.linalg.norm(n), 1e-9)
        pd = float(scene.ground.distance)
        pf = float(scene.ground.static_friction)
        pr = float(scene.ground.restitution)
    else:
        n, pd, pf, pr = np.array([0, 0, 1], np.float32), 0.0, 1.0, 0.0
    return SphereWorldSpec(
        shape_idx=shape_idx,
        free_idx=free_idx,
        body_slot=body_slot,
        allow=np.asarray(allow, bool),
        has_ground=has_ground,
        plane_n=n,
        plane_d=pd,
        plane_friction=pf,
        plane_restitution=pr,
    )


def solve(
    spec: SphereWorldSpec,
    pos,  # (N, F, 3) sphere centers
    vel,  # (N, F, 3)
    omega,  # (N, F, 3)
    radius,  # (N, F)
    inv_m,  # (N, F)
    inv_i,  # (N, F) isotropic world inverse inertia
    mu,  # (N, F) shape friction
    rest,  # (N, F) shape restitution
    h: float,
    iters: int,
    contact_offset: float,
    slop: float,
    bounce_thresh: float,
):
    """Returns (vel', omega', cf (N, F, 3) normal contact force per sphere).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    impl = _cuda_solve if pos.is_cuda else _torch_solve
    return impl(
        spec, pos, vel, omega, radius, inv_m, inv_i, mu, rest,
        float(h), int(iters), float(contact_offset), float(slop),
        float(bounce_thresh),
    )


# ---------------------------------------------------------------------------
# plain PyTorch version: _jnp_solve, line for line
# ---------------------------------------------------------------------------
def _torch_solve(
    spec, pos, vel, omega, radius, inv_m, inv_i, mu, rest,
    h, iters, contact_offset, slop, bounce_thresh,
):
    N, F, _ = pos.shape
    dt = pos.dtype
    dev = pos.device
    allow = torch.as_tensor(spec.allow, device=dev)  # (F, F) upper-tri
    pn = torch.as_tensor(spec.plane_n, dtype=dt, device=dev)
    pd = spec.plane_d

    def cross(a, b):
        return torch.linalg.cross(a, b, dim=-1)

    # --- static pair geometry (positions don't move during the solve) ---
    d = pos[:, :, None, :] - pos[:, None, :, :]  # (N, F, F, 3) x_i - x_j
    dist = torch.linalg.vector_norm(d, dim=-1).clamp_min(1e-9)
    n = d / dist[..., None]  # j -> i
    rsum = radius[:, :, None] + radius[:, None, :]
    depth = rsum - dist
    active = allow[None] & (depth > -contact_offset)
    mu_p = 0.5 * (mu[:, :, None] + mu[:, None, :])
    rest_p = 0.5 * (rest[:, :, None] + rest[:, None, :])

    # ground
    if spec.has_ground:
        dg = torch.einsum("nfk,k->nf", pos, pn) - pd
        depth_g = radius - dg
        active_g = depth_g > -contact_offset
    else:
        depth_g = torch.full((N, F), -1.0, dtype=dt, device=dev)
        active_g = torch.zeros((N, F), dtype=torch.bool, device=dev)
    mu_g = 0.5 * (mu + spec.plane_friction)
    rest_g = 0.5 * (rest + spec.plane_restitution)

    # --- mass splitting counts ---
    af = active.to(dt)
    cnt = af.sum(2) + af.sum(1) + active_g.to(dt)
    inv_cnt = 1.0 / cnt.clamp_min(1.0)

    im_i, im_j = inv_m[:, :, None], inv_m[:, None, :]
    ii_i, ii_j = inv_i[:, :, None], inv_i[:, None, :]
    r_i, r_j = radius[:, :, None], radius[:, None, :]
    k_n = 1.0 / (im_i + im_j).clamp_min(1e-9)
    k_t = 1.0 / (im_i + im_j + r_i * r_i * ii_i + r_j * r_j * ii_j).clamp_min(1e-9)
    k_ng = 1.0 / inv_m.clamp_min(1e-9)
    k_tg = 1.0 / (inv_m + radius * radius * inv_i).clamp_min(1e-9)

    def pair_relvel(v, w):
        # surface velocity at the contact: vr = v_i - v_j - (r_i w_i + r_j w_j) x n
        wmix = r_i[..., None] * w[:, :, None, :] + r_j[..., None] * w[:, None, :, :]
        return v[:, :, None, :] - v[:, None, :, :] - cross(wmix, n)

    h_inv = 1.0 / h
    beta = 0.2
    zero = torch.zeros((), dtype=dt, device=dev)
    vn0 = torch.einsum("nijk,nijk->nij", pair_relvel(vel, omega), n)
    bias = beta * h_inv * (depth - slop).clamp_min(0.0)
    bounce = torch.where(vn0 < -bounce_thresh, -rest_p * vn0, zero)
    tvn = torch.where(depth > slop, torch.maximum(bias, bounce), (depth - slop) * h_inv)

    if spec.has_ground:
        # ground surface velocity: v + w x (-n r) -> normal comp = v.n
        vn0g = torch.einsum("nfk,k->nf", vel, pn)
        bias_g = beta * h_inv * (depth_g - slop).clamp_min(0.0)
        bounce_g = torch.where(vn0g < -bounce_thresh, -rest_g * vn0g, zero)
        tvn_g = torch.where(
            depth_g > slop, torch.maximum(bias_g, bounce_g), (depth_g - slop) * h_inv
        )
    else:
        tvn_g = torch.zeros((N, F), dtype=dt, device=dev)

    relax = 0.8

    def body(v, w, lam, lamt, lam_g, lamt_g):
        vr = pair_relvel(v, w)
        vn = torch.einsum("nijk,nijk->nij", vr, n)
        new_lam = (lam + relax * k_n * (tvn - vn)).clamp_min(0.0)
        dlam = torch.where(active, new_lam - lam, zero)
        new_lam = lam + dlam
        imp = dlam[..., None] * n

        vt = vr - vn[..., None] * n
        vtn = torch.linalg.vector_norm(vt, dim=-1).clamp_min(1e-9)
        tdir = vt / vtn[..., None]
        # scalar accumulated friction magnitude along the (slowly-varying)
        # instantaneous tangent; cone cap mu * lam_n
        new_lamt = torch.minimum(lamt + relax * k_t * vtn, mu_p * new_lam)
        dlamt = torch.where(active, new_lamt - lamt, zero)
        new_lamt = lamt + dlamt
        imp = imp - dlamt[..., None] * tdir

        # apply with mass splitting (i gets +imp, j gets -imp)
        s_i = inv_cnt[:, :, None]
        s_j = inv_cnt[:, None, :]
        dv = torch.einsum("nijk->nik", imp * (im_i * s_i)[..., None]) - torch.einsum(
            "nijk->njk", imp * (im_j * s_j)[..., None]
        )
        # torques: arm_i = -n r_i, arm_j = +n r_j; tau_j = arm_j x (-imp)
        tq = cross(n, imp)  # = n x imp
        dw = torch.einsum(
            "nijk->nik", tq * (-r_i * ii_i * s_i)[..., None]
        ) + torch.einsum("nijk->njk", tq * (-r_j * ii_j * s_j)[..., None])
        v = v + dv
        w = w + dw

        if spec.has_ground:
            vr_g = v - cross(w, pn.expand_as(w)) * radius[..., None]
            vn_g = torch.einsum("nfk,k->nf", vr_g, pn)
            new_lg = (lam_g + relax * k_ng * (tvn_g - vn_g)).clamp_min(0.0)
            dlg = torch.where(active_g, new_lg - lam_g, zero)
            new_lg = lam_g + dlg
            imp_g = dlg[..., None] * pn
            vt_g = vr_g - vn_g[..., None] * pn
            vtn_g = torch.linalg.vector_norm(vt_g, dim=-1).clamp_min(1e-9)
            tdir_g = vt_g / vtn_g[..., None]
            new_ltg = torch.minimum(lamt_g + relax * k_tg * vtn_g, mu_g * new_lg)
            dltg = torch.where(active_g, new_ltg - lamt_g, zero)
            new_ltg = lamt_g + dltg
            imp_g = imp_g - dltg[..., None] * tdir_g
            sg = inv_cnt
            v = v + imp_g * (inv_m * sg)[..., None]
            w = w + cross(-pn * radius[..., None], imp_g) * (inv_i * sg)[..., None]
            lam_g, lamt_g = new_lg, new_ltg
        return v, w, new_lam, new_lamt, lam_g, lamt_g

    z2 = torch.zeros((N, F, F), dtype=dt, device=dev)
    z1 = torch.zeros((N, F), dtype=dt, device=dev)
    carry = (vel, omega, z2, z2, z1, z1)
    for _ in range(iters):
        carry = body(*carry)
    vel, omega, lam, _, lam_g, _ = carry

    # net normal contact force per sphere (both sides + ground)
    f = torch.where(active, lam, zero)[..., None] * n / h
    cf = f.sum(2) - f.sum(1)
    if spec.has_ground:
        cf = cf + (torch.where(active_g, lam_g, zero) / h)[..., None] * pn
    return vel, omega, cf


# ---------------------------------------------------------------------------
# the Hopper kernel's wrapper (csrc/sphere_world.cu)
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int
_ARGTYPES = (
    [_P] * 10  # pos vel omega radius inv_m inv_i mu rest allow_bits row_start
    + [ctypes.c_longlong]  # entries
    + [_P] * 7  # row_cnt rows lams nbs vel_out omega_out cf_out
    + [_I, _I, _I]  # N F iters
    + [_F] * 10  # h contact_offset slop bounce pnx pny pnz pd pf pr
    + [_I, _P]  # has_ground stream
)
_ROW_BYTES = 56  # sizeof(Row) in the kernel


def scratch_layout(N: int, F: int, entries: int):
    """Byte offsets of the kernel's device-memory scratch, 16-byte aligned:
    (rows, lams, nbs, total). row_cnt (N, F) int32 comes first, then rows
    (N, F) 56-byte `Row`s, lams (N, entries) f32 pairs (lam_n, lam_t), nbs
    (N, entries) uint16 neighbour indices. `entries` counts every allowed
    ordered pair, so no contact is dropped: 10 bytes an allowed pair a
    world."""
    def up(x):
        return -(-x // 16) * 16

    at_rows = up(N * F * 4)
    at_lams = up(at_rows + N * F * _ROW_BYTES)
    at_nbs = at_lams + N * entries * 8
    return at_rows, at_lams, at_nbs, up(at_nbs + N * entries * 2)


def _library():
    lib = _kernels.load("sphere_world")
    if lib.sw_solve.argtypes is None:
        lib.sw_solve.argtypes = _ARGTYPES
        lib.sw_solve.restype = ctypes.c_int
        lib.sw_max_spheres.argtypes = []
        lib.sw_max_spheres.restype = ctypes.c_int
        if lib.sw_max_spheres() != MAX_SPHERES:
            raise RuntimeError("csrc/sphere_world.cu kMaxF differs from MAX_SPHERES")
    return lib


def _cuda_solve(
    spec, pos, vel, omega, radius, inv_m, inv_i, mu, rest,
    h, iters, contact_offset, slop, bounce_thresh,
):
    """Launches the broadphase and the sweeps on the current stream."""
    N, F, _ = pos.shape
    if F > MAX_SPHERES:
        raise ValueError(
            f"sphere_world kernel: {F} spheres in a world, more than its "
            f"MAX_SPHERES = {MAX_SPHERES}"
        )
    dev = pos.device
    for name, t, shape in (
        ("pos", pos, (N, F, 3)), ("vel", vel, (N, F, 3)), ("omega", omega, (N, F, 3)),
        ("radius", radius, (N, F)), ("inv_m", inv_m, (N, F)), ("inv_i", inv_i, (N, F)),
        ("mu", mu, (N, F)), ("rest", rest, (N, F)),
    ):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"sphere_world kernel: {name} must be float32 {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"sphere_world kernel: {name} must be contiguous")
    if iters < 1:
        raise ValueError(f"sphere_world kernel: iters must be >= 1, got {iters}")
    bits, row_start = spec.allow_bits, spec.row_start
    if (bits is None or bits.device != dev or tuple(bits.shape) != (F, -(-F // 32))
            or row_start.device != dev or tuple(row_start.shape) != (F + 1,)):
        raise ValueError(
            "sphere_world kernel: the spec has no packed allow mask for "
            f"F = {F} on {dev}; pass spec.to(device), made once and kept"
        )
    at_rows, at_lams, at_nbs, nbytes = scratch_layout(N, F, spec.entries)
    card = torch.cuda.get_device_properties(dev).total_memory
    if nbytes > card:
        raise ValueError(
            f"sphere_world kernel: {N} worlds of {spec.entries} allowed ordered "
            f"pairs need {nbytes} bytes of scratch, more than the {card} of {dev}"
        )
    lib = _library()
    # one scratch allocation at the worst case (every allowed pair live)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    vel_o, om_o, cf_o = torch.empty((3, N, F, 3), dtype=torch.float32, device=dev).unbind(0)
    pn = spec.plane_n
    # the library launches on the current device: make it the tensors' one
    with torch.cuda.device(dev):
        err = lib.sw_solve(
            pos.data_ptr(), vel.data_ptr(), omega.data_ptr(), radius.data_ptr(),
            inv_m.data_ptr(), inv_i.data_ptr(), mu.data_ptr(), rest.data_ptr(),
            bits.data_ptr(), row_start.data_ptr(), spec.entries,
            base, base + at_rows, base + at_lams, base + at_nbs,
            vel_o.data_ptr(), om_o.data_ptr(), cf_o.data_ptr(),
            N, F, iters,
            h, contact_offset, slop, bounce_thresh,
            float(pn[0]), float(pn[1]), float(pn[2]), float(spec.plane_d),
            float(spec.plane_friction), float(spec.plane_restitution),
            1 if spec.has_ground else 0, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sphere_world kernel launch failed: CUDA error {err}")
    _kernels.launches["sphere_world"] += LAUNCHES_PER_SOLVE
    return vel_o, om_o, cf_o
