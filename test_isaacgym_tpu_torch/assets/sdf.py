"""Signed-distance-field collision grids.

Port of test_isaacgym_tpu/assets/sdf.py (host numpy, the same code). The
reference's nut-bolt threading runs on PhysX SDF collision: its URDFs carry
an `<sdf resolution="512"/>` hint inside `<collision>`.

An SDF is a dense (R, R, R) float32 voxel grid in the shape's AABB-centered
local frame, built once on the host (voxelize triangles -> parity sign ->
Euclidean distance transform) and cached per mesh hash. Contact queries are
gathers and trilinear interpolation on the device (physics/contacts.py,
K_PT_SDF). All grids share one resolution R, so every SDF in a scene stacks
into one (K, R, R, R) tensor.

A grid may also carry its closed form (`SdfGrid.analytic`, a function of
torch tensors): the narrowphase then evaluates it, and its autograd
gradient, instead of the voxels. `bolt_sdf_fn` is such a function; it
takes numpy arrays too, for grid baking and the build-time height scans.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, NamedTuple, Optional

import numpy as np

# one shared grid resolution; `<sdf resolution="N">` requests are quantized
# here so heterogeneous assets still stack into one device tensor. 128 puts
# ~5 voxels across an M4 thread flank on a short bolt (anisotropic spacing
# covers the aspect ratio), the scale the nut-bolt assets need.
SDF_RES = 128

_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", ".sdf_cache")
# the cache key's tag: the JAX package shares the cache directory and keys
# its grids "v3-parity"; this package's grids are keyed apart from them
_CACHE_TAG = "v3-parity-torch"


class SdfGrid(NamedTuple):
    """data[ix, iy, iz] = signed distance (meters, + outside) at
    origin + (ix, iy, iz) * spacing, in the mesh's AABB-centered frame.

    `analytic`, when set, is a closed form of the same field, a function of
    torch tensors ((..., 3) local points -> (...) signed distance) that
    autograd differentiates. The contact narrowphase prefers it over the
    voxel data: it is exact and reads no grid."""

    data: np.ndarray  # (R, R, R) float32
    origin: np.ndarray  # (3,) float32
    spacing: np.ndarray  # (3,) float32 per-axis voxel size
    analytic: Optional[Callable] = None


def _grid_coords(lo: np.ndarray, hi: np.ndarray, res: int, pad: int):
    """Voxel layout covering [lo, hi] plus `pad` voxels of margin."""
    extent = np.maximum(hi - lo, 1e-6)
    spacing = extent / (res - 1 - 2 * pad)
    origin = lo - pad * spacing
    return origin.astype(np.float32), spacing.astype(np.float32)


def sdf_from_mesh(
    vertices: np.ndarray,
    faces: Optional[np.ndarray],
    resolution: int = SDF_RES,
    pad: int = 3,
) -> SdfGrid:
    """Voxel SDF of a triangle mesh, cached on disk by mesh hash.

    Method: scatter surface samples into the voxel grid for the DISTANCE
    field, and sign voxels by TRIANGLE RAY-PARITY along each grid axis with
    a 2-of-3 majority vote, then signed distance = EDT(outside) -
    EDT(inside). The parity vote is what makes OPEN production meshes work
    (a hex shell and thread tube without end caps: flood fill finds no
    interior, but the rays along the other axes cross the wall correctly and
    outvote the capless one). Accuracy ~= half a voxel, absorbed by the
    solver's contact/rest offsets.
    """
    from scipy import ndimage

    verts = np.asarray(vertices, np.float32)
    center = (verts.min(0) + verts.max(0)) * 0.5
    verts = verts - center  # AABB-centered local frame (matches scene shapes)

    os.makedirs(_CACHE_DIR, exist_ok=True)
    h = hashlib.sha1(np.ascontiguousarray(verts).tobytes())
    if faces is not None:
        h.update(np.ascontiguousarray(faces, np.int32).tobytes())
    h.update(f"res={resolution}:pad={pad}:{_CACHE_TAG}".encode())
    cache = os.path.join(_CACHE_DIR, h.hexdigest() + ".npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return SdfGrid(z["data"], z["origin"], z["spacing"])

    origin, spacing = _grid_coords(verts.min(0), verts.max(0), resolution, pad)

    # --- surface samples: barycentric lattice per triangle, dense enough
    # that no voxel the surface crosses is missed ---
    if faces is None or len(faces) == 0:
        pts = verts
    else:
        f = np.asarray(faces, np.int64).reshape(-1, 3)
        a, b, c = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
        emax = np.maximum(
            np.linalg.norm(b - a, axis=1),
            np.maximum(np.linalg.norm(c - b, axis=1), np.linalg.norm(a - c, axis=1)),
        )
        k = np.clip(np.ceil(emax / (spacing.min() * 0.5)).astype(int), 1, 24)
        chunks = [verts]
        for kk in np.unique(k):
            sel = k == kk
            # barycentric lattice (i + j <= kk)
            ii, jj = np.meshgrid(np.arange(kk + 1), np.arange(kk + 1))
            m = (ii + jj) <= kk
            u = (ii[m] / kk).astype(np.float32)
            v = (jj[m] / kk).astype(np.float32)
            w = 1.0 - u - v
            p = (
                a[sel][:, None, :] * w[None, :, None]
                + b[sel][:, None, :] * u[None, :, None]
                + c[sel][:, None, :] * v[None, :, None]
            )
            chunks.append(p.reshape(-1, 3))
        pts = np.concatenate(chunks, 0)

    idx = np.round((pts - origin) / spacing).astype(np.int64)
    idx = np.clip(idx, 0, resolution - 1)
    surf = np.zeros((resolution,) * 3, bool)
    surf[idx[:, 0], idx[:, 1], idx[:, 2]] = True

    if faces is not None and len(faces) > 0:
        votes = np.zeros((resolution,) * 3, np.int8)
        f3 = np.asarray(faces, np.int64).reshape(-1, 3)
        tris = verts[f3]  # (F, 3, 3)
        for ax in range(3):
            votes += _ray_parity(tris, origin, spacing, resolution, ax)
        inside = votes >= 2
        # a shell voxel counts as inside so the surface sits at phi ~ 0
        inside |= surf
    else:
        inside = ndimage.binary_fill_holes(surf)
    d_out = ndimage.distance_transform_edt(~inside, sampling=spacing)
    d_in = ndimage.distance_transform_edt(inside, sampling=spacing)
    data = (d_out - d_in).astype(np.float32)

    # written aside and renamed: a process reading the cache never sees a
    # partial file
    part = f"{cache[:-4]}.{os.getpid()}.part.npz"
    np.savez_compressed(part, data=data, origin=origin, spacing=spacing)
    os.replace(part, cache)
    return SdfGrid(data, origin.astype(np.float32), spacing)


def _ray_parity(tris, origin, spacing, resolution, axis):
    """Inside mask by crossing parity along `axis`: for every grid column,
    count triangle crossings below each voxel center; odd = inside.
    Vectorized per triangle over its projected bbox cells; crossings land in
    a (res^3) count array and a cumsum mod 2 gives the parity."""
    a0, a1 = (axis + 1) % 3, (axis + 2) % 3
    res = resolution
    counts = np.zeros((res, res, res), np.int32)
    # cell centers along the two projected axes
    c0 = origin[a0] + spacing[a0] * np.arange(res)
    c1 = origin[a1] + spacing[a1] * np.arange(res)
    pa, pb, pc = tris[:, 0], tris[:, 1], tris[:, 2]
    for t in range(len(tris)):
        A, B, C = pa[t], pb[t], pc[t]
        lo0 = min(A[a0], B[a0], C[a0]); hi0 = max(A[a0], B[a0], C[a0])
        lo1 = min(A[a1], B[a1], C[a1]); hi1 = max(A[a1], B[a1], C[a1])
        i0 = np.searchsorted(c0, [lo0, hi0]); i1 = np.searchsorted(c1, [lo1, hi1])
        if i0[1] <= i0[0] or i1[1] <= i1[0]:
            continue
        g0 = c0[i0[0]:i0[1]]
        g1 = c1[i1[0]:i1[1]]
        P0, P1 = np.meshgrid(g0, g1, indexing="ij")
        # barycentric in the projected plane
        d00 = B[a0] - A[a0]; d01 = B[a1] - A[a1]
        d10 = C[a0] - A[a0]; d11 = C[a1] - A[a1]
        det = d00 * d11 - d01 * d10
        if abs(det) < 1e-18:
            continue
        e0 = P0 - A[a0]; e1 = P1 - A[a1]
        u = (e0 * d11 - e1 * d10) / det
        v = (-e0 * d01 + e1 * d00) / det
        hit = (u >= 0) & (v >= 0) & (u + v <= 1)
        if not hit.any():
            continue
        zc = A[axis] + u * (B[axis] - A[axis]) + v * (C[axis] - A[axis])
        iz = np.clip(
            np.round((zc - origin[axis]) / spacing[axis]).astype(np.int64),
            0, res - 1,
        )
        hi, hj = np.nonzero(hit)
        ii = hi + i0[0]
        jj = hj + i1[0]
        kk = iz[hit]
        if axis == 0:
            np.add.at(counts, (kk, ii, jj), 1)
        elif axis == 1:
            np.add.at(counts, (jj, kk, ii), 1)
        else:
            np.add.at(counts, (ii, jj, kk), 1)
    par = np.cumsum(counts, axis=axis) % 2
    return par.astype(np.int8)


def takes_tensors(fn: Callable) -> bool:
    """Whether `fn` is a closed form the narrowphase can evaluate: called on
    a float32 torch tensor of shape (2, 2, 5, 3) (on the CPU), it returns a
    torch.Tensor of shape (2, 2, 5). A numpy-only fn fails the test: it
    raises, or turns the tensor into a numpy array (through __array__)."""
    import warnings

    import torch

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # numpy's __array_wrap__ notice
            out = fn(torch.zeros((2, 2, 5, 3), dtype=torch.float32))
    except Exception:
        return False
    return isinstance(out, torch.Tensor) and tuple(out.shape) == (2, 2, 5)


def sdf_from_fn(
    fn: Callable[[np.ndarray], np.ndarray],
    lo,
    hi,
    resolution: int = SDF_RES,
    pad: int = 3,
) -> SdfGrid:
    """Exact analytic SDF sampled on the voxel grid. `fn` maps (M, 3) local
    points (AABB-centered frame covering [lo, hi]) to signed distances."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    center = (lo + hi) * 0.5
    origin, spacing = _grid_coords(lo - center, hi - center, resolution, pad)
    ax = [origin[d] + spacing[d] * np.arange(resolution) for d in range(3)]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    p = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    data = np.asarray(fn(p), np.float32).reshape((resolution,) * 3)
    # attach the closed form for inline narrowphase evaluation only if it
    # takes torch tensors; numpy-only fns stay voxel-sampled
    if os.environ.get("TIG_NO_ANALYTIC_SDF") == "1":
        return SdfGrid(data, origin, spacing)
    analytic = fn if takes_tensors(fn) else None
    return SdfGrid(data, origin, spacing, analytic=analytic)


def sample_hull_surface(verts: np.ndarray, n: int = 64, seed: int = 0) -> np.ndarray:
    """n points spread over the convex hull's SURFACE (area-weighted
    per-face sampling). Hull-vert probes alone put every contact point at a
    shape's CORNERS — a gripper pad squeezing a nut then bites only at its
    edges and squirts the nut out; face-distributed probes give the flat
    pinch the reference's SDF contact produces."""
    v = np.asarray(verts, np.float64)
    rng = np.random.RandomState(seed)
    try:
        from scipy.spatial import ConvexHull

        hull = ConvexHull(v)
        tris = v[hull.simplices]  # (F, 3, 3)
    except Exception:
        return farthest_point_sample(v, n).astype(np.float32)
    ab = tris[:, 1] - tris[:, 0]
    ac = tris[:, 2] - tris[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(ab, ac), axis=-1)
    probs = area / max(area.sum(), 1e-12)
    fi = rng.choice(len(tris), size=n, p=probs)
    r1, r2 = rng.uniform(size=(2, n))
    s = np.sqrt(r1)
    pts = (
        tris[fi, 0] * (1 - s)[:, None]
        + tris[fi, 1] * (s * (1 - r2))[:, None]
        + tris[fi, 2] * (s * r2)[:, None]
    )
    # include the verts themselves so edge/corner extremes stay covered
    both = np.concatenate([pts, v], 0)[: n + len(v)]
    return both.astype(np.float32)


def farthest_point_sample(verts: np.ndarray, n: int) -> np.ndarray:
    """Greedy FPS: n well-spread surface sample points (contact probes)."""
    v = np.asarray(verts, np.float32)
    if len(v) <= n:
        reps = int(np.ceil(n / max(len(v), 1)))
        return np.tile(v, (reps, 1))[:n]
    out = np.empty((n, 3), np.float32)
    out[0] = v[0]
    d = np.linalg.norm(v - out[0], axis=1)
    for i in range(1, n):
        j = int(np.argmax(d))
        out[i] = v[j]
        d = np.minimum(d, np.linalg.norm(v - v[j], axis=1))
    return out


# ---------------------------------------------------------------------------
# Procedural ISO metric bolt (the reference's bolt_m4_tight.obj is missing,
# so the mating bolt is generated from the thread parameters measured off
# nut_m4_tight.obj: right-hand thread, phase u = z - pitch*theta/(2pi),
# internal minor r=1.62mm / major r=2.08mm).
# ---------------------------------------------------------------------------


class BoltSpec(NamedTuple):
    major_r: float = 1.95e-3  # external thread crest radius (m)
    minor_r: float = 1.50e-3  # external thread root radius
    pitch: float = 0.7e-3  # right-hand, matches the nut
    crest_phase: float = 0.125e-3  # u of the crest (mates the nut groove)
    length: float = 8e-3  # threaded shank length (short M4x8: keeps the
    #   grid's z-spacing fine enough for the thread profile)
    head_r: float = 3.5e-3  # hex head circumradius
    head_h: float = 2.8e-3  # head height (below z=0)
    scale: float = 1.0  # 5.0 for the *_5x assets
    # conical lead-in at the free end, in pitches: the thread radius tapers
    # below the minor radius so a nut dropped a few mm off-center
    # self-centers onto the taper and the first turn catches. Default 0:
    # the short M4x8 shank is only ~2.5 nut-heights long, so a chamfer
    # overlaps the kinematic-spin env's engaged nut and loosens its fit;
    # only the arm-driven placement env opts in.
    tip_chamfer: float = 0.0


class _NumpyMath:
    """The functions bolt_sdf_fn needs, on numpy arrays."""

    hypot, arctan2, mod = np.hypot, np.arctan2, np.mod
    minimum, maximum, clip = np.minimum, np.maximum, np.clip


class _TorchMath:
    """The same functions on torch tensors. `clip` is written with minimum
    and maximum, whose gradient splits a tie 0.5 / 0.5 as jax.grad of
    jnp.clip does (torch.clamp's gives the whole of it to the input);
    torch.remainder takes the divisor's sign, as jnp.mod does."""

    def __init__(self):
        import torch

        self.hypot, self.arctan2, self.mod = torch.hypot, torch.atan2, torch.remainder
        self.minimum, self.maximum = torch.minimum, torch.maximum

    def _t(self, v, like):
        """A 0-d tensor of value v beside `like`, filled on its device (no
        copy from the host)."""
        import torch

        return torch.full((), v, dtype=like.dtype, device=like.device)

    def clip(self, x, lo, hi):
        import torch

        return torch.minimum(torch.maximum(x, self._t(lo, x)), self._t(hi, x))


def bolt_sdf_fn(spec: BoltSpec):
    """Analytic (approximate) SDF of a threaded bolt: shank axis = +z from
    z=0 to z=length, head below z=0. Thread radius profile is the 60-deg
    triangular ISO form in the helical phase coordinate. The function takes
    numpy arrays (grid baking, the height scans) or torch tensors (the
    narrowphase)."""
    s = spec.scale
    major, minor = spec.major_r * s, spec.minor_r * s
    pitch = spec.pitch * s
    crest = spec.crest_phase * s
    length, head_r, head_h = spec.length * s, spec.head_r * s, spec.head_h * s
    slope = (major - minor) / (0.25 * pitch)  # full depth over p/4 flank run

    def fn(p):
        # fn receives points in the AABB-centered frame; shift back so the
        # shank base sits at z=0
        xp = _NumpyMath if isinstance(p, np.ndarray) else _TorchMath()
        zc = (length - head_h) * 0.5
        x, y, z = p[..., 0], p[..., 1], p[..., 2] + zc
        rho = xp.hypot(x, y)
        theta = xp.arctan2(y, x)
        u = xp.mod(z - pitch * theta / (2 * np.pi) - crest, pitch)
        du = xp.minimum(u, pitch - u)  # distance to crest phase
        r_thread = xp.clip(major - slope * du, minor, major)
        if spec.tip_chamfer > 0:
            ch = spec.tip_chamfer * pitch
            r_tip = major - (major - 0.6 * minor) * xp.clip(
                (z - (length - ch)) / ch, 0.0, 1.0
            )
            r_thread = xp.minimum(r_thread, r_tip)
        # radial distance to the thread surface; axial caps
        d_side = rho - r_thread
        d_cap = xp.maximum(z - length, -z - head_h)
        d_shank = xp.maximum(d_side, xp.maximum(z - length, -z))
        # hex head as a cylinder (collision-equivalent here)
        d_head = xp.maximum(rho - head_r, xp.maximum(z, -z - head_h))
        return xp.minimum(d_shank, d_head) if head_h > 0 else xp.maximum(
            d_side, d_cap
        )

    return fn


def bolt_mesh(spec: BoltSpec, n_theta: int = 48, n_z: int = 160):
    """Triangle mesh of the bolt's threaded surface (for rendering, hulls,
    and sample points). Returns (verts (V,3), faces (F,3))."""
    s = spec.scale
    major, minor = spec.major_r * s, spec.minor_r * s
    pitch = spec.pitch * s
    crest = spec.crest_phase * s
    length, head_r, head_h = spec.length * s, spec.head_r * s, spec.head_h * s
    slope = (major - minor) / (0.25 * pitch)

    th = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    zz = np.linspace(0, length, n_z)
    T, Z = np.meshgrid(th, zz)
    u = np.mod(Z - pitch * T / (2 * np.pi) - crest, pitch)
    du = np.minimum(u, pitch - u)
    R = np.clip(major - slope * du, minor, major)
    if spec.tip_chamfer > 0:  # conical lead-in, matching bolt_sdf_fn
        ch = spec.tip_chamfer * pitch
        r_tip = major - (major - 0.6 * minor) * np.clip(
            (Z - (length - ch)) / ch, 0.0, 1.0
        )
        R = np.minimum(R, r_tip)
    X, Y = R * np.cos(T), R * np.sin(T)
    verts = np.stack([X, Y, Z], -1).reshape(-1, 3)

    def vid(i, j):
        return i * n_theta + (j % n_theta)

    faces = []
    for i in range(n_z - 1):
        for j in range(n_theta):
            faces.append([vid(i, j), vid(i, j + 1), vid(i + 1, j)])
            faces.append([vid(i, j + 1), vid(i + 1, j + 1), vid(i + 1, j)])
    base = len(verts)
    # head: simple cylinder below z=0
    if head_h > 0:
        ring_top = np.stack(
            [head_r * np.cos(th), head_r * np.sin(th), np.zeros_like(th)], -1
        )
        ring_bot = ring_top.copy()
        ring_bot[:, 2] = -head_h
        verts = np.concatenate([verts, ring_top, ring_bot], 0)
        for j in range(n_theta):
            a0, a1 = base + j, base + (j + 1) % n_theta
            b0, b1 = a0 + n_theta, a1 + n_theta
            faces.append([a0, a1, b0])
            faces.append([a1, b1, b0])
    # shift to match the SDF's AABB-centered frame
    zc = (length - head_h) * 0.5
    verts = verts.astype(np.float32)
    verts[:, 2] -= zc
    return verts, np.asarray(faces, np.int32)
