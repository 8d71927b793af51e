"""Reference-compatible handle-based API facade on the PyTorch port.

Port of test_isaacgym_tpu/gymapi/facade.py. This module re-provides the
IsaacGym `gymapi` call surface the reference scripts exercise — handle-based
scene construction, classic structured-array state I/O, the tensor API,
properties, attractors, cameras, and a headless viewer — on top of the
port's `core.Simulator`. Handles are integer indices into batched tensors;
the build phase is eager host Python; the first call that needs physics
finalizes the scene.

Positions in state I/O are env-LOCAL (the convention the reference scripts
assume — see franka_osc.py:144-147 mixing env-local `get_rigid_transform`
init poses with tensor states).

Where the port departs from the JAX facade:
  * Each `Sim` runs on its own `torch.device`: `create_sim` puts it on
    `cuda:{compute_device}` unless `device` says otherwise. There is no CPU
    fallback: `create_sim` raises where that device does not exist, and
    `SimParams.use_gpu_pipeline` moves nothing.
  * The acquire_* handles hold tensors on that device, allocated once (the
    reference's GPU-pipeline semantics): refresh_* copies into them in
    place, `gymtorch.wrap_tensor` returns the same tensor, and set_* calls
    take a tensor on the device without a host round trip (they copy it on
    the device, as the reference copies into its own buffers).
    `get_camera_image_gpu_tensor` aliases the sensor's image on the device;
    the images are buffers that each render overwrites in place.
  * The per-(env, actor) overrides queued before the build are applied as
    one indexed write a field on the host tensors SceneBuilder.finalize
    makes, before the state and parameters go to the device.
  * `render_all_camera_sensors` keeps its scene-wide inputs (ground, light,
    texture atlas, colours, segmentation ids, debug lines) on the device and
    rebuilds them only after a call that changed them.
  * `simulate`, refresh_* and set_*_tensor do not sync with the host;
    `fetch_results` is the one explicit sync point.
  * `create_texture_from_file` raises where neither PIL nor imageio can
    read the file; the JAX facade substitutes a grey texture.

Not a copy of any reference file: the reference only *calls* this API
(its implementation is NVIDIA's closed-source binary).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..assets import load_mjcf, load_urdf
from ..assets.primitives import create_box as _mk_box
from ..assets.primitives import create_capsule as _mk_capsule
from ..assets.primitives import create_sphere as _mk_sphere
from ..assets.types import (
    DOF_PROPS_DTYPE,
    DOF_ROTATION,
    DOF_STATE_DTYPE,
    DOF_TRANSLATION,
    JOINT_FIXED,
    JOINT_FLOATING,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    JOINT_SPHERICAL,
    RIGID_BODY_STATE_DTYPE,
    AssetSpec,
    _quat_mul_np,
    _quat_to_mat_np,
)
from ..core.config import (
    UP_AXIS_Y,
    AssetOptions,
    AttractorProperties,
    CameraProperties,
    PlaneParams,
    SimParams,
)
from ..core.scene import SceneBuilder
from ..core.sim import Simulator
from ..render.camera import CameraSensor
from .mathtypes import Quat, Transform, Vec3

# ---------------------------------------------------------------------------
# enums (names/values follow gymapi where observable)
STATE_NONE = 0
STATE_POS = 1
STATE_VEL = 2
STATE_ALL = 3

DOF_MODE_NONE = 0
DOF_MODE_POS = 1
DOF_MODE_VEL = 2
DOF_MODE_EFFORT = 3

DOMAIN_ACTOR = 0
DOMAIN_ENV = 1
DOMAIN_SIM = 2

ENV_SPACE = 0
LOCAL_SPACE = 1
GLOBAL_SPACE = 2

IMAGE_COLOR = 0
IMAGE_DEPTH = 1
IMAGE_SEGMENTATION = 2
IMAGE_OPTICAL_FLOW = 3

MESH_VISUAL = 0
MESH_COLLISION = 1
MESH_VISUAL_AND_COLLISION = 2

COMPUTE_PER_VERTEX = 0
COMPUTE_PER_FACE = 1
FROM_ASSET = 2

RIGID_BODY_NONE = 0
RIGID_BODY_DISABLE_GRAVITY = 1
RIGID_BODY_DISABLE_SIMULATION = 2

JOINT_MODE_NONE = 0

INVALID_HANDLE = -1
DEFAULT_VIEWER_WIDTH = 1600
DEFAULT_VIEWER_HEIGHT = 900

KEY_R = "KEY_R"
KEY_SPACE = "KEY_SPACE"
KEY_ESCAPE = "KEY_ESCAPE"
MOUSE_LEFT_BUTTON = "MOUSE_LEFT_BUTTON"

_JOINT_TYPE_CODE = {
    JOINT_FIXED: 0,
    JOINT_REVOLUTE: 1,
    JOINT_PRISMATIC: 2,
    JOINT_SPHERICAL: 3,
    JOINT_FLOATING: 4,
}
_JOINT_TYPE_STRING = {
    0: "JOINT_FIXED",
    1: "JOINT_REVOLUTE",
    2: "JOINT_PRISMATIC",
    3: "JOINT_SPHERICAL",
    4: "JOINT_FLOATING",
}
_DOF_TYPE_STRING = {DOF_ROTATION: "DOF_ROTATION", DOF_TRANSLATION: "DOF_TRANSLATION"}


class Env:
    __slots__ = ("sim", "idx")

    def __init__(self, sim: "Sim", idx: int):
        self.sim = sim
        self.idx = idx


class Viewer:
    """Headless viewer: programmatic event injection replaces windowing;
    draw state is recorded, optionally rendered offscreen."""

    def __init__(self, sim: "Sim", props: Optional[CameraProperties]):
        self.sim = sim
        self.props = props or CameraProperties(
            width=DEFAULT_VIEWER_WIDTH, height=DEFAULT_VIEWER_HEIGHT
        )
        self.closed = False
        self.cam_pos = np.array([5.0, 5.0, 3.0])
        self.cam_quat = np.array([0.0, 0, 0, 1.0])
        self.subscriptions: Dict[str, str] = {}
        self._injected: List[Tuple[str, float]] = []
        self.mouse_pos = (0.0, 0.0)
        # debug-draw segments: (env_idx, segs (K, 2, 3) world, colors (K, 3))
        self.lines: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self.frames = 0

    # programmatic injection (replaces real keyboard/mouse)
    def inject_event(self, name: str, value: float = 1.0):
        self._injected.append((name, value))

    def close(self):
        self.closed = True


@dataclasses.dataclass
class _ActionEvent:
    action: str
    value: float


class _TensorHandle:
    """Device-state view returned by acquire_*: `buf` is a tensor on the
    sim's device, allocated once; refresh_* writes into it in place and
    gymtorch.wrap_tensor returns it."""

    __slots__ = ("sim", "name", "buf")

    def __init__(self, sim: "Sim", name: str, buf: torch.Tensor):
        self.sim = sim
        self.name = name
        self.buf = buf

    @property
    def data_address(self) -> int:
        return self.buf.data_ptr()


class _DofFrame:
    __slots__ = ("origin", "axis")

    def __init__(self, origin: Vec3, axis: Vec3):
        self.origin = origin
        self.axis = axis


@dataclasses.dataclass
class RigidShapeProperties:
    """Per-shape material record (get/set_actor_rigid_shape_properties —
    examples/body_physics_props.py:119-172)."""

    friction: float = 1.0
    rolling_friction: float = 0.0
    torsion_friction: float = 0.0
    restitution: float = 0.0
    compliance: float = 0.0
    thickness: float = 0.0
    filter: int = 0


@dataclasses.dataclass
class SoftMaterial:
    """FEM soft-body material record (get/set_actor_soft_materials — the
    reference's examples/soft_body.py:86-133)."""

    youngs: float = 1e5
    poissons: float = 0.45
    damping: float = 0.0
    activation: float = 0.0
    activationMax: float = 0.0
    model: int = 0


@dataclasses.dataclass
class TetTriRange:
    """(start, count) range into the sim-wide tet/tri arrays
    (get_actor_tetrahedra_range — soft_body.py:166-168)."""

    start: int = 0
    count: int = 0


@dataclasses.dataclass
class RigidBodyProperties:
    """Per-body inertial record (get/set_actor_rigid_body_properties —
    examples/body_physics_props.py:191-194)."""

    mass: float = 0.0
    com: object = None
    inertia: object = None
    flags: int = 0
    invMass: float = 0.0

    def __post_init__(self):
        if self.com is None:
            self.com = Vec3()


class _Meta(NamedTuple):
    """An actor slot's layout before the build (core.scene.ActorMeta's
    fields that the facade reads)."""

    asset: AssetSpec
    body_start: int
    body_count: int
    dof_start: int
    dof_count: int
    shape_start: int
    shape_count: int
    name: str


def _put(t: torch.Tensor, rows, cols, values) -> torch.Tensor:
    """t with t[rows, cols] = values, out of place (the JAX .at[].set): one
    indexed write on t's device."""
    dev = t.device
    idx = (torch.as_tensor(rows, dtype=torch.long).to(dev),
           torch.as_tensor(cols, dtype=torch.long).to(dev))
    return t.index_put(idx, torch.as_tensor(values).to(dev, t.dtype))


def _rows_cols(scene, keys, kind: str, counts=None):
    """(env rows, columns) over the `kind` ("dof", "body" or "shape") range
    of each (env, slot) of `keys`, in order: the whole range, or its first
    counts[k] entries."""
    rows, cols = [], []
    for k, (e, slot) in enumerate(keys):
        m = scene.actors[slot]
        start = getattr(m, f"{kind}_start")
        n = getattr(m, f"{kind}_count") if counts is None else counts[k]
        rows.append(np.full(n, e, np.int64))
        cols.append(np.arange(start, start + n, dtype=np.int64))
    return np.concatenate(rows), np.concatenate(cols)


def _apply_dof_props(scene, p, entries: dict):
    """PhysParams with each (env, slot)'s DOF property array written."""
    if not entries:
        return p
    rows, cols = _rows_cols(scene, entries, "dof")
    props = np.concatenate([np.asarray(v) for v in entries.values()])

    def upd(arr, field, dtype=np.float32):
        return _put(arr, rows, cols, props[field].astype(dtype))

    return p._replace(
        dof_stiffness=upd(p.dof_stiffness, "stiffness"),
        dof_damping=upd(p.dof_damping, "damping"),
        dof_armature=upd(p.dof_armature, "armature"),
        dof_friction=upd(p.dof_friction, "friction"),
        dof_lower=upd(p.dof_lower, "lower"),
        dof_upper=upd(p.dof_upper, "upper"),
        dof_has_limits=upd(p.dof_has_limits, "hasLimits", bool),
        dof_max_effort=upd(p.dof_max_effort, "effort"),
        dof_max_velocity=upd(p.dof_max_velocity, "velocity"),
        dof_drive_mode=upd(p.dof_drive_mode, "driveMode", np.int32),
    )


def _apply_dof_states(scene, s, entries: dict):
    if not entries:
        return s
    rows, cols = _rows_cols(scene, entries, "dof")
    st = np.concatenate([np.asarray(v) for v in entries.values()])
    return s._replace(
        dof_pos=_put(s.dof_pos, rows, cols, st["pos"]),
        dof_vel=_put(s.dof_vel, rows, cols, st["vel"]),
    )


def _apply_shape_props(scene, p, entries: dict):
    if not entries:
        return p
    lists = list(entries.values())
    rows, cols = _rows_cols(scene, entries, "shape", [len(v) for v in lists])
    sps = [sp for v in lists for sp in v]
    return p._replace(
        shape_friction=_put(p.shape_friction, rows, cols,
                            np.array([sp.friction for sp in sps], np.float32)),
        shape_restitution=_put(p.shape_restitution, rows, cols,
                               np.array([sp.restitution for sp in sps], np.float32)),
    )


def _apply_body_props(scene, p, entries: dict):
    if not entries:
        return p
    lists = list(entries.values())
    rows, cols = _rows_cols(scene, entries, "body", [len(v) for v in lists])
    bps = [bp for v in lists for bp in v]
    p = p._replace(
        body_mass=_put(p.body_mass, rows, cols, np.array([bp.mass for bp in bps], np.float32)),
        body_com=_put(p.body_com, rows, cols,
                      np.array([[bp.com.x, bp.com.y, bp.com.z] for bp in bps], np.float32)),
        body_disable_gravity=_put(
            p.body_disable_gravity, rows, cols,
            np.array([bool(bp.flags & RIGID_BODY_DISABLE_GRAVITY) for bp in bps])),
    )
    has = np.array([getattr(bp, "inertia", None) is not None for bp in bps])
    if has.any():
        inertia = np.array([bp.inertia for bp, h in zip(bps, has) if h], np.float32)
        p = p._replace(body_inertia=_put(p.body_inertia, rows[has], cols[has], inertia))
    return p


def _apply_scales(scene, p, entries: dict):
    """Scales collision geometry + inertial params (set_actor_scale —
    examples/actor_scaling.py:126). Articulated joint frames stay at the
    asset's scale (the JAX facade's documented limitation)."""
    if not entries:
        return p
    keys, scales = list(entries), np.array(list(entries.values()), np.float32)
    srows, scols = _rows_cols(scene, keys, "shape")
    brows, bcols = _rows_cols(scene, keys, "body")
    s_sh = np.repeat(scales, [scene.actors[slot].shape_count for _, slot in keys])
    s_b = np.repeat(scales, [scene.actors[slot].body_count for _, slot in keys])

    def mul(arr, rows, cols, f):
        dev = arr.device
        r, c = torch.as_tensor(rows).to(dev), torch.as_tensor(cols).to(dev)
        f = torch.as_tensor(f).to(dev, arr.dtype).reshape((-1,) + (1,) * (arr.dim() - 2))
        return arr.index_put((r, c), arr[r, c] * f)

    return p._replace(
        shape_size=mul(p.shape_size, srows, scols, s_sh),
        shape_pos=mul(p.shape_pos, srows, scols, s_sh),
        body_mass=mul(p.body_mass, brows, bcols, s_b**3),
        body_com=mul(p.body_com, brows, bcols, s_b),
        body_inertia=mul(p.body_inertia, brows, bcols, s_b**5),
    )


def _apply_targets(scene, a, entries: dict, field: str):
    if not entries:
        return a
    rows, cols = _rows_cols(scene, entries, "dof")
    t = np.concatenate([np.asarray(v, np.float32) for v in entries.values()])
    return a._replace(**{field: _put(getattr(a, field), rows, cols, t)})


class Sim:
    """Sim handle: builder-phase registries + the finalized Simulator, on
    `device`."""

    def __init__(self, params: SimParams, device):
        self.params = params
        self.device = torch.device(device)
        if self.device.type == "cuda" and (self.device.index or 0) >= (
                torch.cuda.device_count() if torch.cuda.is_available() else 0):
            raise RuntimeError(f"create_sim: no CUDA device {self.device} here "
                               f"(pass device='cpu' for the CPU)")
        self.builder = SceneBuilder(params)
        self.sim: Optional[Simulator] = None
        self.envs: List[Env] = []
        self.assets: List[AssetSpec] = []
        self._t0 = time.time()
        # per-(env, slot) pending overrides applied at finalize
        self._dof_props: Dict[Tuple[int, int], np.ndarray] = {}
        self._dof_states: Dict[Tuple[int, int], np.ndarray] = {}
        self._shape_props: Dict[Tuple[int, int], list] = {}
        self._body_props: Dict[Tuple[int, int], list] = {}
        self._scales: Dict[Tuple[int, int], float] = {}
        self._pos_targets: Dict[Tuple[int, int], np.ndarray] = {}
        self._vel_targets: Dict[Tuple[int, int], np.ndarray] = {}
        self._pending_dof_targets: list = []  # (env, dof_handle, target)
        # tensor-API buffers
        self._tensors: Dict[str, _TensorHandle] = {}
        self._jacobians: Dict[str, tuple] = {}
        self._mass_matrices: Dict[str, tuple] = {}
        # cameras / graphics
        self.cameras: List[CameraSensor] = []
        self._cam_counter: Dict[int, int] = {}
        self.lights = {
            0: (
                np.array([0.8, 0.8, 0.8]),
                np.array([0.25, 0.25, 0.25]),
                np.array([-0.3, -0.3, -1.0]) / np.linalg.norm([0.3, 0.3, 1.0]),
            )
        }
        self.textures: List[np.ndarray] = []
        self._shape_color: Optional[np.ndarray] = None  # (N, S, 3)
        self._shape_tex: Optional[np.ndarray] = None  # (N, S) texture id, -1 none
        self._pending_colors: list = []  # (env_idx, slot, body, rgb) pre-build
        self._render_tables = None
        # the render's scene-wide inputs on the device; None after a call
        # that changed one of them
        self._render_inputs: Optional[dict] = None
        self._oneshot_force = False
        self._oneshot_effort = False
        self.viewer: Optional[Viewer] = None

    # -- build/finalize ------------------------------------------------------
    @property
    def built(self) -> bool:
        return self.sim is not None

    def _ensure_built(self):
        if self.sim is not None:
            return
        # the overrides go into the host tensors finalize makes, one indexed
        # write a field, before the Simulator moves them to the device
        scene, state, params = self.builder.finalize("cpu")
        params = _apply_dof_props(scene, params, self._dof_props)
        state = _apply_dof_states(scene, state, self._dof_states)
        params = _apply_shape_props(scene, params, self._shape_props)
        params = _apply_body_props(scene, params, self._body_props)
        params = _apply_scales(scene, params, self._scales)
        self.sim = Simulator(scene, state, params, device=self.device)
        a = _apply_targets(scene, self.sim.actions, self._pos_targets, "dof_pos_target")
        a = _apply_targets(scene, a, self._vel_targets, "dof_vel_target")
        last = {(e, dof): tgt for e, dof, tgt in self._pending_dof_targets}
        if last:
            rows, cols = zip(*last)
            a = a._replace(dof_pos_target=_put(a.dof_pos_target, rows, cols,
                                               np.array(list(last.values()), np.float32)))
        self.sim.actions = a
        from ..render.raster import tables_from_scene

        self._render_tables = tables_from_scene(scene)
        self._shape_color = np.tile(
            self._render_tables.color[None], (scene.num_envs, 1, 1)
        ).astype(np.float32)
        self._shape_tex = np.full(
            (scene.num_envs, scene.shapes.count), -1, np.int32
        )
        for e, slot, body, color in self._pending_colors:
            m = scene.actors[slot]
            mask = scene.shapes.body_slot == (m.body_start + body)
            self._shape_color[e, mask] = color
        self._pending_colors = []

    def _origin(self, env_idx) -> np.ndarray:
        """Env origin(s), f32 on the host (the Simulator's env_origins,
        without a device read)."""
        return np.asarray(self.sim.scene.env_origins, np.float32)[env_idx]

    # -- layout ----------------------------------------------------------------
    def _meta(self, slot: int):
        if self.built:
            return self.sim.scene.actors[slot]
        # pre-build: reconstruct offsets from proto layout
        body, dof, shape = 0, 0, 0
        for s, p in enumerate(self.builder.envs[0]):
            ns = sum(len(l.geoms) for l in p.asset.links)
            if s == slot:
                return _Meta(p.asset, body, p.asset.num_bodies, dof, p.asset.num_dofs,
                             shape, ns, p.name)
            body += p.asset.num_bodies
            dof += p.asset.num_dofs
            shape += ns
        raise IndexError(slot)

    def _slot_of_body_prebuild(self, env_idx: int, body_handle: int) -> int:
        b = 0
        for slot, p in enumerate(self.builder.envs[env_idx]):
            if body_handle < b + p.asset.num_bodies:
                return slot
            b += p.asset.num_bodies
        raise IndexError(body_handle)

    # -- host FK for pre-build queries ---------------------------------------
    def _host_fk(self, env_idx: int, slot: int):
        """Eager per-actor FK from initial pose + pending dof states.
        Spherical joints evaluated at zero; revolute/prismatic/fixed exact."""
        proto = self.builder.envs[env_idx][slot]
        asset = proto.asset
        q = np.zeros(asset.num_dofs)
        if (env_idx, slot) in self._dof_states:
            q = self._dof_states[(env_idx, slot)]["pos"].astype(np.float64)
        pos = np.zeros((asset.num_bodies, 3))
        quat = np.zeros((asset.num_bodies, 4))
        pos[0] = proto.pos
        quat[0] = proto.quat
        di = 0
        for i, l in enumerate(asset.links):
            j = l.joint
            if j is None:
                continue
            pp, pq = pos[l.parent], quat[l.parent]
            jp = pp + _quat_to_mat_np(pq) @ np.asarray(j.parent_pos)
            jq = _quat_mul_np(pq, j.parent_quat)
            if j.jtype == JOINT_REVOLUTE:
                ax = np.asarray(j.axis) / max(np.linalg.norm(j.axis), 1e-9)
                h = q[di] / 2
                rq = np.array([*(np.sin(h) * ax), np.cos(h)])
                jq = _quat_mul_np(jq, rq)
                di += 1
            elif j.jtype == JOINT_PRISMATIC:
                ax = np.asarray(j.axis) / max(np.linalg.norm(j.axis), 1e-9)
                jp = jp + _quat_to_mat_np(jq) @ (ax * q[di])
                di += 1
            else:
                di += j.num_dofs
            pos[i] = jp + _quat_to_mat_np(jq) @ np.asarray(j.child_pos)
            quat[i] = _quat_mul_np(jq, j.child_quat)
        return pos, quat

    def _render_changed(self):
        self._render_inputs = None


def _tensor_data(sim: Sim, t) -> torch.Tensor:
    """A set_* / apply_* argument as an f32 tensor of its own on the sim's
    device: a handle's buffer or a tensor is copied on the device (no host
    round trip); numpy goes up once."""
    if isinstance(t, _TensorHandle):
        t = t.buf
    if isinstance(t, torch.Tensor):
        return t.detach().to(sim.device, torch.float32, copy=True)
    return torch.as_tensor(np.asarray(t, np.float32), device=sim.device)


def _np(t) -> np.ndarray:
    """A host copy (a CPU tensor's numpy view would follow later in-place
    writes, as the image buffers and tensor handles take)."""
    return t.detach().to("cpu", copy=True).numpy()


# ---------------------------------------------------------------------------
class Gym:
    """The API singleton returned by acquire_gym() — every method mirrors a
    reference call site. It holds no device: each Sim carries its own."""

    # -- lifecycle ----------------------------------------------------------
    def create_sim(
        self,
        compute_device: int = 0,
        graphics_device: int = 0,
        engine: int = 0,
        params: Optional[SimParams] = None,
        device=None,
    ) -> Sim:
        """A Sim on `device`, by default "cuda:{compute_device}"; raises where
        that CUDA device does not exist."""
        return Sim(params or SimParams(), device or f"cuda:{compute_device}")

    def prepare_sim(self, sim: Sim) -> bool:
        sim._ensure_built()
        return True

    def simulate(self, sim: Sim):
        sim._ensure_built()
        sim.sim.step()
        if sim._oneshot_force:
            a = sim.sim.actions
            sim.sim.actions = a._replace(
                body_force=torch.zeros_like(a.body_force),
                body_torque=torch.zeros_like(a.body_torque),
                dof_effort=torch.zeros_like(a.dof_effort)
                if sim._oneshot_effort
                else a.dof_effort,
                use_force_pos=torch.zeros_like(a.use_force_pos),
            )
            sim._oneshot_force = False
            sim._oneshot_effort = False

    def fetch_results(self, sim: Sim, wait: bool = True):
        """The one explicit sync point: waits for the sim's device."""
        if sim.built and sim.device.type == "cuda":
            torch.cuda.synchronize(sim.device)

    def step_graphics(self, sim: Sim):
        pass  # body transforms are always fresh (functional state)

    def sync_frame_time(self, sim: Sim):
        pass  # headless: no realtime throttle

    def get_sim_time(self, sim: Sim) -> float:
        return float(sim.sim.state.time) if sim.built else 0.0

    def get_elapsed_time(self, sim: Sim) -> float:
        return time.time() - sim._t0

    def get_frame_count(self, sim: Sim) -> int:
        return int(sim.sim.state.steps) if sim.built else 0

    def destroy_sim(self, sim: Sim):
        sim.sim = None

    # -- world building -----------------------------------------------------
    def add_ground(self, sim: Sim, params: PlaneParams):
        sim.builder.add_ground(params)

    def add_triangle_mesh(self, sim: Sim, vertices, triangles, params):
        """Static triangle-mesh collider (terrain —
        examples/terrain_creation.py:119). Contact is heightfield-native:
        the mesh is rasterized back to a heightfield (exact for
        terrain_utils grids); the trimesh itself is kept for rendering."""
        v = np.asarray(vertices, np.float32).reshape(-1, 3)
        t = np.asarray(triangles, np.uint32).reshape(-1, 3)
        ox = oy = 0.0
        if params is not None and getattr(params, "transform", None) is not None:
            ox, oy = params.transform.p.x, params.transform.p.y
        sim.builder.trimesh = (v, t, params)
        sim.builder.add_trimesh_as_heightfield(v, t, offset_x=ox, offset_y=oy)

    def add_heightfield(self, sim: Sim, heightfield_raw, params):
        """Native heightfield terrain (gymapi.HeightFieldParams semantics:
        row/column spacing + vertical scale + transform offset)."""
        hs = getattr(params, "column_scale", getattr(params, "horizontal_scale", 1.0))
        vs = getattr(params, "vertical_scale", 1.0)
        ox = oy = 0.0
        if getattr(params, "transform", None) is not None:
            ox, oy = params.transform.p.x, params.transform.p.y
        sim.builder.add_heightfield(
            np.asarray(heightfield_raw), hs, vs, offset_x=ox, offset_y=oy
        )

    def create_env(self, sim: Sim, lower: Vec3, upper: Vec3, per_row: int) -> Env:
        i = sim.builder.create_env(
            (lower.x, lower.y, lower.z), (upper.x, upper.y, upper.z), per_row
        )
        env = Env(sim, i)
        sim.envs.append(env)
        return env

    def create_actor(
        self,
        env: Env,
        asset: AssetSpec,
        pose: Transform,
        name: str = "actor",
        group: int = 0,
        filter: int = 0,
        seg_id: int = 0,
    ) -> int:
        if env.sim.built:
            raise RuntimeError(
                "create_actor after the scene was finalized (first simulate/"
                "state access); build the whole scene first"
            )
        return env.sim.builder.create_actor(
            env.idx,
            asset,
            pos=(pose.p.x, pose.p.y, pose.p.z),
            quat=(pose.r.x, pose.r.y, pose.r.z, pose.r.w),
            name=name,
            group=group,
            filter=filter,
            seg_id=seg_id,
        )

    # -- assets ---------------------------------------------------------------
    def load_asset(
        self, sim: Sim, rootpath: str, filename: str, options: Optional[AssetOptions] = None
    ) -> AssetSpec:
        options = options or AssetOptions()
        kw = dict(
            fix_base_link=options.fix_base_link,
            armature=options.armature,
            density=options.density,
            default_dof_drive_mode=options.default_dof_drive_mode,
        )
        if filename.lower().endswith((".xml", ".mjcf")):
            asset = load_mjcf(rootpath, filename, **kw)
        else:
            asset = load_urdf(
                rootpath,
                filename,
                collapse_fixed=options.collapse_fixed_joints,
                use_mesh_materials=options.use_mesh_materials,
                **kw,
            )
        asset.disable_gravity = options.disable_gravity
        # COMPUTE_PER_VERTEX (0, default) = smooth interpolated normals in
        # the visual-mesh render pass; anything else = flat face normals
        # (graphics_materials.py:30 mesh_normal_mode semantics)
        asset.mesh_normal_mode = options.mesh_normal_mode
        asset.thickness = options.thickness
        asset.linear_damping = options.linear_damping
        asset.angular_damping = options.angular_damping
        asset.max_linear_velocity = options.max_linear_velocity
        asset.max_angular_velocity = options.max_angular_velocity
        if options.vhacd_enabled:
            # convex decomposition at asset-load time through the native
            # VHACD tool (assets/vhacd.py raises where it is missing)
            from ..assets.vhacd import decompose_asset

            decompose_asset(asset, options.vhacd_params)
        sim.assets.append(asset)
        return asset

    def create_box(self, sim: Sim, sx, sy, sz, options: Optional[AssetOptions] = None):
        o = options or AssetOptions()
        return _mk_box(sx, sy, sz, density=o.density, **_prim_opts(o))

    def create_sphere(self, sim: Sim, radius, options: Optional[AssetOptions] = None):
        o = options or AssetOptions()
        return _mk_sphere(radius, density=o.density, **_prim_opts(o))

    def create_capsule(self, sim: Sim, radius, half_len, options=None):
        o = options or AssetOptions()
        return _mk_capsule(radius, half_len, density=o.density, **_prim_opts(o))

    # asset introspection (test/test01_isaacgym_asset.py:12-40)
    def get_asset_rigid_body_count(self, asset: AssetSpec) -> int:
        return asset.num_bodies

    def get_asset_rigid_body_names(self, asset) -> List[str]:
        return asset.rigid_body_names()

    def get_asset_rigid_body_name(self, asset, i: int) -> str:
        return asset.rigid_body_names()[i]

    def get_asset_rigid_body_dict(self, asset) -> dict:
        return asset.rigid_body_dict()

    def get_asset_joint_count(self, asset) -> int:
        return asset.num_joints

    def get_asset_joint_names(self, asset) -> List[str]:
        return asset.joint_names()

    def get_asset_joint_name(self, asset, i: int) -> str:
        return asset.joint_names()[i]

    def get_asset_joint_dict(self, asset) -> dict:
        return asset.joint_dict()

    def get_asset_joint_type(self, asset, i: int) -> int:
        return _JOINT_TYPE_CODE[asset.joints[i].jtype]

    def get_joint_type_string(self, jtype: int) -> str:
        return _JOINT_TYPE_STRING[int(jtype)]

    def get_asset_dof_count(self, asset) -> int:
        return asset.num_dofs

    def get_asset_dof_names(self, asset) -> List[str]:
        return asset.dof_names()

    def get_asset_dof_name(self, asset, i: int) -> str:
        return asset.dof_names()[i]

    def get_asset_dof_dict(self, asset) -> dict:
        return asset.dof_dict()

    def get_asset_dof_type(self, asset, i: int) -> int:
        return asset.dof_types()[i]

    def get_dof_type_string(self, dtype: int) -> str:
        return _DOF_TYPE_STRING[int(dtype)]

    def get_asset_dof_properties(self, asset) -> np.ndarray:
        return asset.dof_properties()

    def get_asset_actuator_count(self, asset) -> int:
        return 0

    def get_asset_tendon_count(self, asset) -> int:
        return 0

    def get_asset_soft_body_count(self, asset) -> int:
        """Count of `<fem>` links (soft_body.py:84) — XPBD backend
        (physics/soft.py)."""
        return sum(1 for l in asset.links if getattr(l, "fem", None) is not None)

    def get_asset_soft_materials(self, asset) -> list:
        return [
            SoftMaterial(
                youngs=l.fem.youngs,
                poissons=l.fem.poissons,
                damping=l.fem.damping,
            )
            for l in asset.links
            if getattr(l, "fem", None) is not None
        ]

    # -- actor introspection --------------------------------------------------
    def get_actor_count(self, env: Env) -> int:
        return len(env.sim.builder.envs[env.idx])

    def get_actor_handle(self, env: Env, i: int) -> int:
        return i

    def get_actor_name(self, env: Env, actor: int) -> str:
        return env.sim.builder.envs[env.idx][actor].name

    def find_actor_handle(self, env: Env, name: str) -> int:
        for i, p in enumerate(env.sim.builder.envs[env.idx]):
            if p.name == name:
                return i
        return INVALID_HANDLE

    def get_env_count(self, sim: Sim) -> int:
        return len(sim.envs)

    def get_env(self, sim: Sim, i: int) -> Env:
        return sim.envs[i]

    def _asset_of(self, env: Env, actor: int) -> AssetSpec:
        return env.sim.builder.envs[env.idx][actor].asset

    def get_actor_rigid_body_count(self, env: Env, actor: int) -> int:
        return self._asset_of(env, actor).num_bodies

    def get_actor_rigid_body_names(self, env, actor) -> List[str]:
        return self._asset_of(env, actor).rigid_body_names()

    def get_actor_rigid_body_dict(self, env, actor) -> dict:
        return self._asset_of(env, actor).rigid_body_dict()

    def get_actor_joint_count(self, env, actor) -> int:
        return self._asset_of(env, actor).num_joints

    def get_actor_joint_names(self, env, actor) -> List[str]:
        return self._asset_of(env, actor).joint_names()

    def get_actor_joint_dict(self, env, actor) -> dict:
        return self._asset_of(env, actor).joint_dict()

    def get_actor_dof_count(self, env, actor) -> int:
        return self._asset_of(env, actor).num_dofs

    def get_actor_dof_names(self, env, actor) -> List[str]:
        return self._asset_of(env, actor).dof_names()

    def get_actor_dof_dict(self, env, actor) -> dict:
        return self._asset_of(env, actor).dof_dict()

    def get_actor_rigid_body_handle(self, env: Env, actor: int, i: int) -> int:
        return env.sim._meta(actor).body_start + i

    def find_actor_rigid_body_handle(self, env: Env, actor: int, name: str) -> int:
        d = self._asset_of(env, actor).rigid_body_dict()
        if name not in d:
            return INVALID_HANDLE
        return env.sim._meta(actor).body_start + d[name]

    def find_actor_rigid_body_index(
        self, env: Env, actor: int, name: str, domain: int = DOMAIN_SIM
    ) -> int:
        d = self._asset_of(env, actor).rigid_body_dict()
        i = d[name]
        m = env.sim._meta(actor)
        if domain == DOMAIN_ACTOR:
            return i
        if domain == DOMAIN_ENV:
            return m.body_start + i
        B = self._bodies_per_env(env.sim)
        return env.idx * B + m.body_start + i

    def get_actor_rigid_body_index(self, env, actor, i: int, domain: int = DOMAIN_SIM):
        m = env.sim._meta(actor)
        if domain == DOMAIN_ACTOR:
            return i
        if domain == DOMAIN_ENV:
            return m.body_start + i
        return env.idx * self._bodies_per_env(env.sim) + m.body_start + i

    def find_actor_index(self, env: Env, name: str, domain: int = DOMAIN_SIM) -> int:
        slot = self.find_actor_handle(env, name)
        if slot == INVALID_HANDLE:
            return INVALID_HANDLE
        if domain == DOMAIN_ACTOR or domain == DOMAIN_ENV:
            return slot
        return env.idx * len(env.sim.builder.envs[env.idx]) + slot

    def get_rigid_handle(self, env: Env, actor_name: str, body_name: str) -> int:
        return self.find_actor_rigid_body_handle(
            env, self.find_actor_handle(env, actor_name), body_name
        )

    def get_actor_dof_handle(self, env: Env, actor: int, i: int) -> int:
        return env.sim._meta(actor).dof_start + i

    def find_actor_dof_handle(self, env: Env, actor: int, name: str) -> int:
        d = self._asset_of(env, actor).dof_dict()
        if name not in d:
            return INVALID_HANDLE
        return env.sim._meta(actor).dof_start + d[name]

    def find_actor_dof_index(self, env, actor, name, domain=DOMAIN_SIM) -> int:
        d = self._asset_of(env, actor).dof_dict()
        i = d[name]
        m = env.sim._meta(actor)
        if domain == DOMAIN_ACTOR:
            return i
        if domain == DOMAIN_ENV:
            return m.dof_start + i
        return env.idx * self._dofs_per_env(env.sim) + m.dof_start + i

    def get_joint_handle(self, env: Env, actor_name: str, joint_name: str) -> int:
        slot = self.find_actor_handle(env, actor_name)
        d = self._asset_of(env, slot).joint_dict()
        return env.sim._meta(slot).dof_start + d.get(joint_name, INVALID_HANDLE)

    @staticmethod
    def _bodies_per_env(sim: Sim) -> int:
        if sim.built:
            return sim.sim.scene.num_bodies_per_env
        return sum(p.asset.num_bodies for p in sim.builder.envs[0])

    @staticmethod
    def _dofs_per_env(sim: Sim) -> int:
        if sim.built:
            return sim.sim.scene.num_dofs_per_env
        return sum(p.asset.num_dofs for p in sim.builder.envs[0])

    # -- classic state I/O ----------------------------------------------------
    def _body_states_struct(self, sim: Sim, env_idx, body_slice) -> np.ndarray:
        """Structured states of bodies body_slice of env(s) env_idx (an int,
        or a slice over envs: env-major rows), env-local."""
        sim._ensure_built()
        st = sim.sim.state
        org = sim._origin(env_idx)[..., None, :]
        pos = _np(st.body_pos[env_idx, body_slice]) - org
        quat = _np(st.body_quat[env_idx, body_slice])
        lin = _np(st.body_linvel[env_idx, body_slice])
        ang = _np(st.body_angvel[env_idx, body_slice])
        pos, quat, lin, ang = (x.reshape(-1, x.shape[-1]) for x in (pos, quat, lin, ang))
        out = np.zeros(len(pos), RIGID_BODY_STATE_DTYPE)
        for k, f in enumerate("xyz"):
            out["pose"]["p"][f] = pos[:, k]
            out["vel"]["linear"][f] = lin[:, k]
            out["vel"]["angular"][f] = ang[:, k]
        for k, f in enumerate("xyzw"):
            out["pose"]["r"][f] = quat[:, k]
        return out

    def get_actor_rigid_body_states(self, env: Env, actor: int, flags=STATE_ALL):
        m = env.sim._meta(actor)
        if not env.sim.built:
            pos, quat = env.sim._host_fk(env.idx, actor)
            out = np.zeros(m.body_count, RIGID_BODY_STATE_DTYPE)
            for k, f in enumerate("xyz"):
                out["pose"]["p"][f] = pos[:, k]
            for k, f in enumerate("xyzw"):
                out["pose"]["r"][f] = quat[:, k]
            return out
        return self._body_states_struct(
            env.sim, env.idx, slice(m.body_start, m.body_start + m.body_count)
        )

    def _set_roots(self, sim: Sim, env_rows, slots, roots, flags):
        """Write root rows (structured (K,) env-local states) of actors
        (env_rows[k], slots[k]), then refresh the body states."""
        s = sim.sim
        org = sim._origin(np.asarray(env_rows))
        p, r = roots["pose"]["p"], roots["pose"]["r"]
        lv, av = roots["vel"]["linear"], roots["vel"]["angular"]

        def stack(a, fields):
            return np.stack([a[f] for f in fields], -1).astype(np.float32)

        state = s.state
        kw = {}
        if flags in (STATE_ALL, STATE_POS):
            kw["root_pos"] = _put(state.root_pos, env_rows, slots, stack(p, "xyz") + org)
            kw["root_quat"] = _put(state.root_quat, env_rows, slots, stack(r, "xyzw"))
        if flags in (STATE_ALL, STATE_VEL):
            kw["root_linvel"] = _put(state.root_linvel, env_rows, slots, stack(lv, "xyz"))
            kw["root_angvel"] = _put(state.root_angvel, env_rows, slots, stack(av, "xyz"))
        s.state = s.stepper.refresh_body_state(state._replace(**kw), s.params)

    def set_actor_rigid_body_states(self, env: Env, actor: int, states, flags=STATE_ALL):
        """Root-pose/velocity write. For articulated actors only the root body
        row is applied (reduced coordinates own the rest); single-body
        actors (the reference's kinematic UAV/car scenes, test04:359-387)
        are exact."""
        env.sim._ensure_built()
        self._set_roots(env.sim, [env.idx], [actor], np.asarray(states)[:1], flags)
        return True

    def get_sim_rigid_body_states(self, sim: Sim, flags=STATE_ALL) -> np.ndarray:
        """(num_envs*B,) struct snapshot (1080_balls_of_solitude.py:150)."""
        sim._ensure_built()
        return self._body_states_struct(
            sim, slice(None), slice(0, sim.sim.scene.num_bodies_per_env)
        )

    def set_sim_rigid_body_states(self, sim: Sim, states, flags=STATE_ALL):
        """Snapshot restore: root states of every actor are restored (one
        write of all of them, one refresh); dofs are left untouched (the
        reference scenes using this are single-body)."""
        sim._ensure_built()
        scene = sim.sim.scene
        st = np.asarray(states).reshape(len(sim.envs), -1)
        starts = [m.body_start for m in scene.actors]
        n, a = len(sim.envs), len(starts)
        self._set_roots(sim, np.repeat(np.arange(n), a), np.tile(np.arange(a), n),
                        st[:, starts].reshape(-1), flags)
        return True

    def get_actor_dof_states(self, env: Env, actor: int, flags=STATE_ALL) -> np.ndarray:
        m = env.sim._meta(actor)
        out = np.zeros(m.dof_count, DOF_STATE_DTYPE)
        if not env.sim.built:
            pend = env.sim._dof_states.get((env.idx, actor))
            if pend is not None:
                out[:] = pend
            return out
        st = env.sim.sim.state
        out["pos"] = _np(st.dof_pos[env.idx, m.dof_start : m.dof_start + m.dof_count])
        out["vel"] = _np(st.dof_vel[env.idx, m.dof_start : m.dof_start + m.dof_count])
        return out

    def set_actor_dof_states(self, env: Env, actor: int, states, flags=STATE_ALL) -> bool:
        st = np.asarray(states)
        if st.dtype != DOF_STATE_DTYPE:
            st = st.astype(DOF_STATE_DTYPE)
        if env.sim.built:
            s = env.sim.sim
            s.state = s.stepper.refresh_body_state(
                _apply_dof_states(s.scene, s.state, {(env.idx, actor): st}), s.params
            )
        else:
            env.sim._dof_states[(env.idx, actor)] = st.copy()
        return True

    def get_actor_dof_position_targets(self, env: Env, actor: int) -> np.ndarray:
        m = env.sim._meta(actor)
        if env.sim.built:
            return _np(env.sim.sim.actions.dof_pos_target[
                env.idx, m.dof_start : m.dof_start + m.dof_count
            ])
        t = env.sim._pos_targets.get((env.idx, actor))
        return t.copy() if t is not None else np.zeros(m.dof_count, np.float32)

    def _set_actor_targets(self, env: Env, actor: int, targets, field: str, pending: dict):
        t = np.asarray(targets, np.float32)
        if env.sim.built:
            s = env.sim.sim
            s.actions = _apply_targets(s.scene, s.actions, {(env.idx, actor): t}, field)
        else:
            pending[(env.idx, actor)] = t.copy()
        return True

    def set_actor_dof_position_targets(self, env: Env, actor: int, targets) -> bool:
        return self._set_actor_targets(env, actor, targets, "dof_pos_target",
                                       env.sim._pos_targets)

    def set_actor_dof_velocity_targets(self, env: Env, actor: int, targets) -> bool:
        return self._set_actor_targets(env, actor, targets, "dof_vel_target",
                                       env.sim._vel_targets)

    def _set_dof_action(self, env: Env, dof_handle: int, value: float, field: str):
        a = env.sim.sim.actions
        env.sim.sim.actions = a._replace(
            **{field: _put(getattr(a, field), [env.idx], [dof_handle], [value])}
        )

    # per-DOF classic control (examples/dof_controls.py:96-181)
    def set_dof_target_position(self, env: Env, dof_handle: int, target: float):
        if not env.sim.built:
            # called inside the env-creation loop (soft_body.py:137): defer
            # — finalizing here would break subsequent create_actor calls
            env.sim._pending_dof_targets.append((env.idx, dof_handle, target))
            return
        self._set_dof_action(env, dof_handle, target, "dof_pos_target")

    def set_dof_target_velocity(self, env: Env, dof_handle: int, target: float):
        env.sim._ensure_built()
        self._set_dof_action(env, dof_handle, target, "dof_vel_target")

    def apply_dof_effort(self, env: Env, dof_handle: int, effort: float):
        """One-shot effort for the next simulate (dof_controls.py:142-150)."""
        env.sim._ensure_built()
        self._set_dof_action(env, dof_handle, effort, "dof_effort")
        env.sim._oneshot_force = True
        env.sim._oneshot_effort = True

    def get_dof_position(self, env: Env, dof_handle: int) -> float:
        env.sim._ensure_built()
        return float(env.sim.sim.state.dof_pos[env.idx, dof_handle])

    def get_dof_velocity(self, env: Env, dof_handle: int) -> float:
        env.sim._ensure_built()
        return float(env.sim.sim.state.dof_vel[env.idx, dof_handle])

    def set_joint_target_position(self, env: Env, joint_handle: int, target: float):
        self.set_dof_target_position(env, joint_handle, target)

    def get_dof_frame(self, env: Env, dof_handle: int) -> _DofFrame:
        """World frame of a DOF's joint (joint_monkey.py:255-262)."""
        env.sim._ensure_built()
        from ..physics.kinematics import fk, joint_world_frames

        s = env.sim.sim
        for gi in s.stepper.groups:
            hits = (gi.dof_idx == dof_handle).nonzero()
            if not len(hits):
                continue
            copy, dg = (int(x) for x in hits[0])
            st = s.state
            slots = gi.slots
            pos, quat, _, _ = fk(
                gi.topo,
                st.root_pos[:, slots],
                st.root_quat[:, slots],
                st.root_linvel[:, slots],
                st.root_angvel[:, slots],
                st.dof_pos[:, gi.dof_idx],
                st.dof_vel[:, gi.dof_idx],
            )
            anchors, axes = joint_world_frames(
                gi.topo, pos[env.idx, copy], quat[env.idx, copy]
            )
            link = [
                l for l in range(gi.topo.num_links) if gi.topo.dof_of_link[l] == dg
            ][0]
            a = _np(anchors[link]) - env.sim._origin(env.idx)
            x = _np(axes[link])
            return _DofFrame(Vec3(*a), Vec3(*x))
        raise KeyError(f"dof handle {dof_handle} not in any articulation")

    def get_rigid_transform(self, env: Env, body_handle: int) -> Transform:
        """Env-local body pose (franka_osc.py:145)."""
        if not env.sim.built:
            # host FK over the owning actor
            b = 0
            for slot, p in enumerate(env.sim.builder.envs[env.idx]):
                if body_handle < b + p.asset.num_bodies:
                    pos, quat = env.sim._host_fk(env.idx, slot)
                    i = body_handle - b
                    return Transform(Vec3(*pos[i]), Quat(*quat[i]))
                b += p.asset.num_bodies
            raise IndexError(body_handle)
        st = env.sim.sim.state
        p = _np(st.body_pos[env.idx, body_handle]) - env.sim._origin(env.idx)
        q = _np(st.body_quat[env.idx, body_handle])
        return Transform(Vec3(*p), Quat(*q))

    def get_rigid_linear_velocity(self, env: Env, body_handle: int) -> Vec3:
        env.sim._ensure_built()
        return Vec3(*_np(env.sim.sim.state.body_linvel[env.idx, body_handle]))

    def get_rigid_angular_velocity(self, env: Env, body_handle: int) -> Vec3:
        env.sim._ensure_built()
        return Vec3(*_np(env.sim.sim.state.body_angvel[env.idx, body_handle]))

    def set_rigid_linear_velocity(self, env: Env, body_handle: int, vel: Vec3):
        """Kinematic velocity write on a body (test03:266-270). Applies to the
        owning actor's root (exact for single-body actors)."""
        self._set_rigid_velocity(env, body_handle, vel, "root_linvel")

    def set_rigid_angular_velocity(self, env: Env, body_handle: int, vel: Vec3):
        self._set_rigid_velocity(env, body_handle, vel, "root_angvel")

    def _set_rigid_velocity(self, env: Env, body_handle: int, vel, field: str):
        env.sim._ensure_built()
        s = env.sim.sim
        slot = self._slot_of_body(env.sim, body_handle)
        v = np.array([[vel.x, vel.y, vel.z]], np.float32)
        st = s.state._replace(**{field: _put(getattr(s.state, field), [env.idx], [slot], v)})
        s.state = s.stepper.refresh_body_state(st, s.params)

    @staticmethod
    def _slot_of_body(sim: Sim, body_handle: int) -> int:
        for slot, m in enumerate(sim.sim.scene.actors):
            if m.body_start <= body_handle < m.body_start + m.body_count:
                return slot
        raise IndexError(body_handle)

    # -- properties -----------------------------------------------------------
    def get_actor_dof_properties(self, env: Env, actor: int) -> np.ndarray:
        key = (env.idx, actor)
        if not env.sim.built and key in env.sim._dof_props:
            return env.sim._dof_props[key].copy()
        if env.sim.built:
            m = env.sim._meta(actor)
            sl = slice(m.dof_start, m.dof_start + m.dof_count)
            p = env.sim.sim.params
            out = np.zeros(m.dof_count, DOF_PROPS_DTYPE)
            out["stiffness"] = _np(p.dof_stiffness[env.idx, sl])
            out["damping"] = _np(p.dof_damping[env.idx, sl])
            out["armature"] = _np(p.dof_armature[env.idx, sl])
            out["friction"] = _np(p.dof_friction[env.idx, sl])
            out["lower"] = _np(p.dof_lower[env.idx, sl])
            out["upper"] = _np(p.dof_upper[env.idx, sl])
            out["hasLimits"] = _np(p.dof_has_limits[env.idx, sl])
            out["effort"] = _np(p.dof_max_effort[env.idx, sl])
            out["velocity"] = _np(p.dof_max_velocity[env.idx, sl])
            out["driveMode"] = _np(p.dof_drive_mode[env.idx, sl])
            return out
        return self._asset_of(env, actor).dof_properties()

    def set_actor_dof_properties(self, env: Env, actor: int, props) -> bool:
        arr = np.asarray(props)
        if env.sim.built:
            s = env.sim.sim
            s.params = _apply_dof_props(s.scene, s.params, {(env.idx, actor): arr})
        else:
            env.sim._dof_props[(env.idx, actor)] = arr.copy()
        return True

    def get_actor_rigid_shape_properties(self, env: Env, actor: int) -> list:
        key = (env.idx, actor)
        if key in env.sim._shape_props and not env.sim.built:
            return [dataclasses.replace(sp) for sp in env.sim._shape_props[key]]
        m = env.sim._meta(actor)
        geoms = [g for l in self._asset_of(env, actor).links for g in l.geoms]
        if env.sim.built:
            p = env.sim.sim.params
            sl = slice(m.shape_start, m.shape_start + len(geoms))
            fr = _np(p.shape_friction[env.idx, sl])
            re = _np(p.shape_restitution[env.idx, sl])
            return [RigidShapeProperties(friction=float(f), restitution=float(r))
                    for f, r in zip(fr, re)]
        return [RigidShapeProperties(friction=g.friction, restitution=g.restitution)
                for g in geoms]

    def set_actor_rigid_shape_properties(self, env: Env, actor: int, props: list):
        if env.sim.built:
            s = env.sim.sim
            s.params = _apply_shape_props(s.scene, s.params, {(env.idx, actor): props})
        else:
            env.sim._shape_props[(env.idx, actor)] = [
                dataclasses.replace(sp) for sp in props
            ]
        return True

    def get_actor_rigid_body_properties(self, env: Env, actor: int) -> list:
        m = env.sim._meta(actor)
        links = self._asset_of(env, actor).links
        out = []
        if env.sim.built:
            p = env.sim.sim.params
            sl = slice(m.body_start, m.body_start + len(links))
            mass, com = _np(p.body_mass[env.idx, sl]), _np(p.body_com[env.idx, sl])
            inertia = _np(p.body_inertia[env.idx, sl])
            nograv = _np(p.body_disable_gravity[env.idx, sl])
            for i in range(len(links)):
                out.append(RigidBodyProperties(
                    mass=float(mass[i]), com=Vec3(*com[i]), inertia=inertia[i],
                    flags=RIGID_BODY_DISABLE_GRAVITY if nograv[i] else RIGID_BODY_NONE))
            return out
        sc = env.sim._scales.get((env.idx, actor), 1.0)
        for l in links:
            out.append(RigidBodyProperties(
                mass=l.mass * sc**3, com=Vec3(*(np.asarray(l.com) * sc)),
                inertia=np.asarray(l.inertia) * sc**5))
        return out

    def set_actor_rigid_body_properties(
        self, env: Env, actor: int, props: list, recomputeInertia: bool = False
    ):
        if recomputeInertia:
            for bp, l in zip(props, self._asset_of(env, actor).links):
                if l.mass > 0:
                    bp.inertia = np.asarray(l.inertia) * (bp.mass / l.mass)
        if env.sim.built:
            s = env.sim.sim
            s.params = _apply_body_props(s.scene, s.params, {(env.idx, actor): props})
        else:
            env.sim._body_props[(env.idx, actor)] = list(props)
        return True

    def set_actor_scale(self, env: Env, actor: int, scale: float) -> bool:
        if env.sim.built:
            s = env.sim.sim
            s.params = _apply_scales(s.scene, s.params, {(env.idx, actor): float(scale)})
        else:
            env.sim._scales[(env.idx, actor)] = float(scale) * env.sim._scales.get(
                (env.idx, actor), 1.0
            )
        return True

    def get_actor_scale(self, env: Env, actor: int) -> float:
        return env.sim._scales.get((env.idx, actor), 1.0)

    def _soft_instances_of(self, env: Env, actor: int):
        """Soft-instance indices of one actor slot (requires built sim)."""
        env.sim._ensure_built()
        soft = env.sim.sim.scene.soft
        if soft is None:
            return []
        return [
            i for i, inst in enumerate(soft.instances)
            if inst.actor_slot == actor
        ]

    def get_actor_soft_materials(self, env, actor) -> list:
        idx = self._soft_instances_of(env, actor)
        p = env.sim.sim.params
        return [
            SoftMaterial(
                youngs=float(p.soft_youngs[env.idx, i]),
                poissons=float(p.soft_poissons[env.idx, i]),
                damping=float(p.soft_damping[env.idx, i]),
            )
            for i in idx
        ]

    def set_actor_soft_materials(self, env, actor, mats) -> bool:
        """Per-env material update — a pure tensor write on PhysParams
        (soft_body.py:120-133 randomizes Young's/Poisson per env)."""
        idx = self._soft_instances_of(env, actor)
        if not idx or len(mats) < len(idx):
            return False
        sim = env.sim.sim
        p = sim.params
        rows, mats = [env.idx] * len(idx), mats[: len(idx)]
        sim.params = p._replace(
            soft_youngs=_put(p.soft_youngs, rows, idx,
                             np.asarray([m.youngs for m in mats], np.float32)),
            soft_poissons=_put(p.soft_poissons, rows, idx,
                               np.asarray([m.poissons for m in mats], np.float32)),
            soft_damping=_put(p.soft_damping, rows, idx,
                              np.asarray([m.damping for m in mats], np.float32)),
        )
        return True

    # -- soft-body introspection (get_sim_tetrahedra/triangles ---------------
    # soft_body.py:160-186 reads these for stress/pressure viz)
    def get_sim_tetrahedra(self, sim: Sim):
        """(tet_indices flat [4*T_sim], tet_stress [(3,3) ndarray per tet])
        across ALL envs (env-major, like the reference's sim-wide arrays)."""
        sim._ensure_built()
        soft = sim.sim.scene.soft
        if soft is None:
            return [], []
        stress = _np(sim.sim.stepper.soft.tet_stress(sim.sim.state.soft_pos, sim.sim.params))
        N = stress.shape[0]
        V = soft.num_verts
        idx = (
            soft.tets[None, :, :] + (np.arange(N) * V)[:, None, None]
        ).reshape(-1)
        return idx.tolist(), list(stress.reshape(-1, 3, 3))

    def get_sim_triangles(self, sim: Sim):
        """(tri_indices flat [3*S_sim], tri_parents [S_sim], tri_normals)."""
        sim._ensure_built()
        soft = sim.sim.scene.soft
        if soft is None:
            return [], [], []
        normals = _np(sim.sim.stepper.soft.tri_normals(sim.sim.state.soft_pos))
        N = normals.shape[0]
        V, T = soft.num_verts, soft.num_tets
        idx = (
            soft.tris[None, :, :] + (np.arange(N) * V)[:, None, None]
        ).reshape(-1)
        par = (
            soft.tri_parent[None, :] + (np.arange(N) * T)[:, None]
        ).reshape(-1)
        return idx.tolist(), par.tolist(), list(normals.reshape(-1, 3))

    def _soft_instance_at(self, env: Env, actor: int, soft_index: int):
        """Validated lookup: empty range for actors with no soft bodies or
        an out-of-range soft_index (instead of a bare IndexError)."""
        idx = self._soft_instances_of(env, actor)
        soft = env.sim.sim.scene.soft
        if soft is None or not (0 <= soft_index < len(idx)):
            return None, None
        return soft, soft.instances[idx[soft_index]]

    def get_actor_tetrahedra_range(self, env: Env, actor: int, soft_index: int):
        soft, inst = self._soft_instance_at(env, actor, soft_index)
        if inst is None:
            return TetTriRange(start=0, count=0)
        return TetTriRange(
            start=env.idx * soft.num_tets + inst.tet_start,
            count=inst.tet_count,
        )

    def get_actor_triangle_range(self, env: Env, actor: int, soft_index: int):
        soft, inst = self._soft_instance_at(env, actor, soft_index)
        if inst is None:
            return TetTriRange(start=0, count=0)
        return TetTriRange(
            start=env.idx * len(soft.tris) + inst.tri_start,
            count=inst.tri_count,
        )

    # -- tensor API -----------------------------------------------------------
    _STATE_TENSORS = {
        "root": lambda s: s.root_state,
        "body": lambda s: s.body_state,
        "dof": lambda s: s.dof_state,
        "contact": lambda s: s.net_contact_force,
    }

    def _acquire(self, sim: Sim, name: str) -> _TensorHandle:
        """The state handle `name`, its tensor allocated on the device at the
        first acquire."""
        sim._ensure_built()
        if name not in sim._tensors:
            buf = self._STATE_TENSORS[name](sim.sim).clone()
            sim._tensors[name] = _TensorHandle(sim, name, buf)
        return sim._tensors[name]

    def _refresh(self, sim: Sim, name: str):
        h = sim._tensors.get(name)
        if h is not None:
            h.buf.copy_(self._STATE_TENSORS[name](sim.sim))

    def acquire_actor_root_state_tensor(self, sim: Sim) -> _TensorHandle:
        """(num_envs * actors, 13) env-local root states."""
        return self._acquire(sim, "root")

    def acquire_rigid_body_state_tensor(self, sim: Sim) -> _TensorHandle:
        """(num_envs * bodies, 13) env-local body states."""
        return self._acquire(sim, "body")

    def acquire_dof_state_tensor(self, sim: Sim) -> _TensorHandle:
        """(num_envs * dofs, 2) rows of [pos, vel]."""
        return self._acquire(sim, "dof")

    def acquire_net_contact_force_tensor(self, sim: Sim) -> _TensorHandle:
        """(num_envs * bodies, 3) net contact forces."""
        return self._acquire(sim, "contact")

    def _acquire_fn(self, sim: Sim, registry: dict, prefix: str, actor_name: str, fn):
        fn_h = registry.get(actor_name)
        if fn_h is None:
            fn_h = (fn, _TensorHandle(sim, f"{prefix}:{actor_name}", fn(sim.sim.state).clone()))
            registry[actor_name] = fn_h
        return fn_h[1]

    def acquire_jacobian_tensor(self, sim: Sim, actor_name: str) -> _TensorHandle:
        sim._ensure_built()
        return self._acquire_fn(sim, sim._jacobians, "jac", actor_name,
                                sim.sim.jacobian_fn(actor_name))

    def acquire_mass_matrix_tensor(self, sim: Sim, actor_name: str) -> _TensorHandle:
        sim._ensure_built()
        return self._acquire_fn(sim, sim._mass_matrices, "mm", actor_name,
                                sim.sim.mass_matrix_fn(actor_name))

    def refresh_actor_root_state_tensor(self, sim: Sim) -> bool:
        self._refresh(sim, "root")
        return True

    def refresh_rigid_body_state_tensor(self, sim: Sim) -> bool:
        self._refresh(sim, "body")
        return True

    def refresh_dof_state_tensor(self, sim: Sim) -> bool:
        self._refresh(sim, "dof")
        return True

    def refresh_net_contact_force_tensor(self, sim: Sim) -> bool:
        self._refresh(sim, "contact")
        return True

    def refresh_jacobian_tensors(self, sim: Sim) -> bool:
        for fn, h in sim._jacobians.values():
            h.buf.copy_(fn(sim.sim.state))
        return True

    def refresh_mass_matrix_tensors(self, sim: Sim) -> bool:
        for fn, h in sim._mass_matrices.values():
            h.buf.copy_(fn(sim.sim.state))
        return True

    def set_actor_root_state_tensor(self, sim: Sim, tensor) -> bool:
        sim._ensure_built()
        sim.sim.root_state = _tensor_data(sim, tensor)
        return True

    def set_rigid_body_state_tensor(self, sim: Sim, tensor) -> bool:
        """Applies root rows of every actor (reduced coordinates own link
        poses; exact for the reference's single-body vecenv scenes —
        test05:367-385)."""
        sim._ensure_built()
        s = sim.sim
        data = _tensor_data(sim, tensor).reshape(
            s.scene.num_envs, s.scene.num_bodies_per_env, 13
        )
        starts = torch.as_tensor([m.body_start for m in s.scene.actors]).to(sim.device)
        s.root_state = data[:, starts].reshape(-1, 13)
        return True

    def set_dof_state_tensor(self, sim: Sim, tensor) -> bool:
        sim._ensure_built()
        sim.sim.dof_state = _tensor_data(sim, tensor)
        return True

    def set_dof_position_target_tensor(self, sim: Sim, tensor) -> bool:
        sim._ensure_built()
        sim.sim.set_dof_position_targets(_tensor_data(sim, tensor))
        return True

    def set_dof_velocity_target_tensor(self, sim: Sim, tensor) -> bool:
        sim._ensure_built()
        sim.sim.set_dof_velocity_targets(_tensor_data(sim, tensor))
        return True

    def set_dof_actuation_force_tensor(self, sim: Sim, tensor) -> bool:
        sim._ensure_built()
        sim.sim.set_dof_actuation_forces(_tensor_data(sim, tensor))
        return True

    def apply_rigid_body_force_tensors(
        self, sim: Sim, forces=None, torques=None, space: int = ENV_SPACE
    ) -> bool:
        """(apply_forces.py:117) — forces act on the NEXT simulate only."""
        sim._ensure_built()
        s = sim.sim
        f = None if forces is None else _tensor_data(sim, forces)
        t = None if torques is None else _tensor_data(sim, torques)
        s.apply_body_forces(forces=f, torques=t)
        sim._oneshot_force = True
        return True

    def apply_rigid_body_force_at_pos_tensors(
        self, sim: Sim, forces=None, positions=None, space: int = ENV_SPACE
    ) -> bool:
        sim._ensure_built()
        s = sim.sim
        sh = (s.scene.num_envs, s.scene.num_bodies_per_env, 3)
        f = None if forces is None else _tensor_data(sim, forces)
        p = None if positions is None else _tensor_data(sim, positions).reshape(sh)
        if p is not None and space == ENV_SPACE:
            p = p + s.env_origins[:, None, :]
        s.apply_body_forces(forces=f, positions=p)
        sim._oneshot_force = True
        return True

    def apply_body_forces(
        self, env: Env, body_handle: int, force=None, torque=None, space=ENV_SPACE
    ):
        env.sim._ensure_built()
        a = env.sim.sim.actions
        if force is not None:
            a = a._replace(body_force=_put(a.body_force, [env.idx], [body_handle],
                                           [[force.x, force.y, force.z]]))
        if torque is not None:
            a = a._replace(body_torque=_put(a.body_torque, [env.idx], [body_handle],
                                            [[torque.x, torque.y, torque.z]]))
        env.sim.sim.actions = a
        env.sim._oneshot_force = True

    # -- attractors (franka_attractor.py:89-173) -------------------------------
    def create_rigid_body_attractor(self, env: Env, props: AttractorProperties) -> int:
        if env.sim.built:
            raise RuntimeError("attractors must be created before the scene builds")
        target = props.target or Transform()
        offset = props.offset or Transform()
        slot = env.sim._slot_of_body_prebuild(env.idx, props.rigid_handle)
        m = env.sim._meta(slot)
        idx = env.sim.builder.add_attractor(
            env.idx,
            slot=slot,
            body=props.rigid_handle - m.body_start,
            offset_pos=(offset.p.x, offset.p.y, offset.p.z),
            offset_quat=(offset.r.x, offset.r.y, offset.r.z, offset.r.w),
            axes=props.axes,
            stiffness=props.stiffness,
            damping=props.damping,
            force_limit=props.forceLimit,
            target_pos=(target.p.x, target.p.y, target.p.z),
            target_quat=(target.r.x, target.r.y, target.r.z, target.r.w),
        )
        return idx

    def get_attractor_properties(self, env: Env, handle: int) -> AttractorProperties:
        a = env.sim.builder.attractors[env.idx][handle]
        p = AttractorProperties()
        p.stiffness = a.stiffness
        p.damping = a.damping
        p.forceLimit = a.force_limit
        p.axes = a.axes
        p.rigid_handle = a.body
        p.target = Transform(Vec3(*a.target_pos), Quat(*a.target_quat))
        p.offset = Transform(Vec3(*a.offset_pos), Quat(*a.offset_quat))
        return p

    def set_attractor_target(self, env: Env, handle: int, target: Transform) -> bool:
        a = env.sim.builder.attractors[env.idx][handle]
        a.target_pos = np.array([target.p.x, target.p.y, target.p.z])
        a.target_quat = np.array([target.r.x, target.r.y, target.r.z, target.r.w])
        if env.sim.built:
            s = env.sim.sim
            org = env.sim._origin(env.idx)
            act = s.actions
            s.actions = act._replace(
                attractor_target_pos=_put(act.attractor_target_pos, [env.idx], [handle],
                                          (a.target_pos + org).astype(np.float32)[None]),
                attractor_target_quat=_put(act.attractor_target_quat, [env.idx], [handle],
                                           a.target_quat.astype(np.float32)[None]),
            )
        return True

    def set_attractor_properties(self, env: Env, handle: int, props) -> bool:
        a = env.sim.builder.attractors[env.idx][handle]
        a.stiffness, a.damping, a.force_limit = (
            props.stiffness,
            props.damping,
            props.forceLimit,
        )
        a.axes = props.axes
        if env.sim.built:
            p = env.sim.sim.params
            e, h = [env.idx], [handle]
            env.sim.sim.params = p._replace(
                attractor_stiffness=_put(p.attractor_stiffness, e, h, [props.stiffness]),
                attractor_damping=_put(p.attractor_damping, e, h, [props.damping]),
                attractor_force_limit=_put(p.attractor_force_limit, e, h, [props.forceLimit]),
            )
        return True

    # -- cameras (test02:226-344, graphics.py:156-238) --------------------------
    def create_camera_sensor(self, env: Env, props: CameraProperties) -> int:
        """Cameras created per env in the standard loop collapse into one
        batched sensor on the sim's device; the handle is the sensor index
        (stable across envs)."""
        sim = env.sim
        c = sim._cam_counter.get(env.idx, 0)
        sim._cam_counter[env.idx] = c + 1
        if env.idx == 0 or c >= len(sim.cameras):
            n = max(len(sim.builder.envs), 1)
            sim.cameras.append(CameraSensor(
                props=dataclasses.replace(props), num_envs=n, device=str(sim.device)))
            sim._render_changed()
            return len(sim.cameras) - 1
        return c

    def destroy_camera_sensor(self, sim: Sim, env: Env, cam: int) -> bool:
        sim.cameras[cam].destroyed = True
        return True

    def attach_camera_to_body(
        self, cam: int, env: Env, body_handle: int, local: Transform, mode: int
    ):
        env.sim.cameras[cam].attach(
            body_handle,
            (local.p.x, local.p.y, local.p.z),
            (local.r.x, local.r.y, local.r.z, local.r.w),
            follow_mode=mode,
        )

    def set_camera_location(self, cam: int, env: Env, eye: Vec3, target: Vec3):
        up = (0, 1, 0) if env.sim.params.up_axis == UP_AXIS_Y else (0, 0, 1)
        env.sim.cameras[cam].set_location(
            env.idx, (eye.x, eye.y, eye.z), (target.x, target.y, target.z), up
        )

    def set_camera_transform(self, cam: int, env: Env, t: Transform):
        env.sim.cameras[cam].set_transform(
            env.idx, (t.p.x, t.p.y, t.p.z), (t.r.x, t.r.y, t.r.z, t.r.w)
        )

    def set_camera_horizontal_fov(self, cam: int, env: Env, fov_deg: float):
        """Per-env runtime camera zoom (framework extension: replaces
        test11's 90-cameras-per-env fov sweep with one camera whose fov is
        a per-env tensor — test11_servo_vecenv_camerazoom.py:327-335,
        409-410)."""
        env.sim.cameras[cam].set_horizontal_fov(env.idx, fov_deg)
        env.sim._render_changed()

    def get_camera_transform(self, sim: Sim, env: Env, cam: int) -> Transform:
        sim._ensure_built()
        p, q = sim.cameras[cam].env_pose(sim.sim.state, sim.sim.env_origins)
        return Transform(Vec3(*_np(p[env.idx])), Quat(*_np(q[env.idx])))

    def get_camera_proj_matrix(self, sim: Sim, env: Env, cam: int) -> np.ndarray:
        return sim.cameras[cam].proj_matrix()

    def get_camera_view_matrix(self, sim: Sim, env: Env, cam: int) -> np.ndarray:
        sim._ensure_built()
        return sim.cameras[cam].view_matrix(
            sim.sim.state, sim.sim.env_origins, env.idx
        )

    def _render_scene_inputs(self, sim: Sim) -> dict:
        """The render's scene-wide inputs as tensors on the sim's device,
        built after a call that changed them and reused by every frame until
        the next: ground, light, sky, texture atlas and ids, colours,
        segmentation ids, the shape tables (`RenderTables.to`), the static
        mesh tables, each sensor's fov, and the viewer's debug lines padded
        per env."""
        if sim._render_inputs is not None:
            return sim._render_inputs
        from ..render.raster import TEX_RES, resample_texture

        s, dev, tbl = sim.sim, sim.device, sim._render_tables
        N = s.scene.num_envs

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x)).to(dev, dtype)

        g = s.scene.ground
        if g is not None:
            n = np.asarray(g.normal, np.float32)
            n = n / max(np.linalg.norm(n), 1e-9)
            ground = np.array([*n, g.distance], np.float32)
        else:
            ground = np.zeros(4, np.float32)
        color, ambient, ldir = sim.lights[0]
        out = dict(
            ground=t(ground),
            light_dir=t(np.asarray(ldir / max(np.linalg.norm(ldir), 1e-9), np.float32)),
            light_color=t(np.asarray(color, np.float32)),
            ambient=t(np.asarray(ambient, np.float32)),
            bg=t(np.array([0.32, 0.45, 0.6], np.float32)),  # sky
            color=t(sim._shape_color),
            kind=t(tbl.kind, torch.int32),
            seg=t(tbl.seg, torch.int32),
            tex=None,
            tex_id=None,
            body=t(tbl.body, torch.long),
            tables=tbl.to(dev),  # shape_world_poses' tables, read each frame
            mesh_rows=tuple(int(r) for r in tbl.mesh_rows),
            mesh_planes=t(tbl.mesh_planes),
            mesh_base=t(tbl.mesh_base),
        )
        # stacked texture atlas
        if any(x is not None for x in sim.textures) and (sim._shape_tex >= 0).any():
            out["tex"] = t(np.stack([
                resample_texture(x) if x is not None
                else np.zeros((TEX_RES, TEX_RES, 3), np.float32)
                for x in sim.textures
            ]))
            out["tex_id"] = t(sim._shape_tex, torch.int32)
        # visual triangle meshes: static local tables
        tri_kw = {}
        if len(tbl.tri_shape):
            tri_kw = dict(
                tri_shape=tuple(int(r) for r in tbl.tri_shape),
                tri_v=t(tbl.tri_v),
                tri_n=t(tbl.tri_n),
                tri_base=tuple(
                    tuple(float(x) for x in row)
                    for row in np.asarray(s.scene.shapes.size, np.float32)
                ),
            )
        # viewer debug-draw lines, zero-padded per env (the JAX facade's
        # padding, which draws a point at the origin: ROADMAP Queue 3)
        viewer = sim.viewer
        if viewer is not None and viewer.lines:
            Lmax = max(
                sum(len(sg) for e2, sg, _ in viewer.lines if e2 == e)
                for e in range(N)
            )
            if Lmax > 0:
                lseg = np.zeros((N, Lmax, 2, 3), np.float32)
                lcol = np.zeros((N, Lmax, 3), np.float32)
                fill = np.zeros(N, np.int64)
                for e2, sg, cl in viewer.lines:
                    k = fill[e2]
                    lseg[e2, k : k + len(sg)] = sg
                    lcol[e2, k : k + len(sg)] = cl
                    fill[e2] += len(sg)
                tri_kw.update(lines=t(lseg), line_colors=t(lcol))
        out["tri_kw"] = tri_kw
        hfov = []
        for sensor in sim.cameras:
            if sensor.fov_per_env is not None:
                h = np.full(N, sensor.props.horizontal_fov, np.float32)
                m = min(N, len(sensor.fov_per_env))
                h[:m] = sensor.fov_per_env[:m]
            else:
                h = np.full(N, sensor.props.horizontal_fov, np.float32)
            hfov.append(t(h))
        out["hfov"] = hfov
        sim._render_inputs = out
        return out

    def render_all_camera_sensors(self, sim: Sim):
        sim._ensure_built()
        from ..render.raster import render_camera_batch, shape_world_poses

        s = sim.sim
        r = self._render_scene_inputs(sim)
        sp, sq = shape_world_poses(s.state, s.params, r["tables"], s.scene)
        tri_kw = dict(r["tri_kw"])
        # soft surface triangles render as a world-frame soup
        if s.scene.soft is not None and s.state.soft_pos is not None:
            tris = torch.as_tensor(np.asarray(s.scene.soft.tris), dtype=torch.long,
                                   device=sim.device)
            tri_kw.update(
                soft_tris=s.state.soft_pos[:, tris],
                soft_colors=np.asarray([0.82, 0.45, 0.35], np.float32),
            )
        for sensor, hfov in zip(sim.cameras, r["hfov"]):
            if sensor.destroyed:
                continue
            cp, cq = sensor.world_pose(s.state, s.env_origins)
            ss = max(
                1,
                int(getattr(sensor.props, "supersampling_horizontal", 1)),
                int(getattr(sensor.props, "supersampling_vertical", 1)),
            )
            flow_kw = {}
            if sensor.want_flow:
                flow_kw = dict(
                    body_lin=s.state.body_linvel[:, r["body"]],
                    body_ang=s.state.body_angvel[:, r["body"]],
                    body_ctr=s.state.body_pos[:, r["body"]],
                    flow_dt=float(s.scene.sim_params.dt),
                )
            rgba, depth, seg, flow = render_camera_batch(
                cp,
                cq,
                sp,
                sq,
                s.params.shape_size,
                r["kind"],
                r["color"],
                r["seg"],
                r["ground"],
                r["light_dir"],
                r["light_color"],
                r["ambient"],
                r["bg"],
                hfov,
                r["tex"],
                r["tex_id"],
                mesh_rows=r["mesh_rows"],
                mesh_planes=r["mesh_planes"],
                mesh_base=r["mesh_base"],
                **tri_kw,
                width=sensor.props.width,
                height=sensor.props.height,
                far=float(sensor.props.far_plane),
                ss=ss,
                **flow_kw,
            )
            # the images stay on the device, in buffers each render
            # overwrites in place: get_camera_image_gpu_tensor's handles
            # alias them (interop_torch.py:115-120); the classic
            # get_camera_image reads them back
            for name, img in (("color", rgba), ("depth", depth),
                              ("segmentation", seg), ("flow", flow)):
                buf = getattr(sensor, name)
                if img is None or buf is None or buf.shape != img.shape:
                    setattr(sensor, name, img)
                else:
                    buf.copy_(img)

    def get_camera_image(self, sim: Sim, env: Env, cam: int, kind: int):
        sensor = sim.cameras[cam]
        if sensor.color is None:
            self.render_all_camera_sensors(sim)
        h, w = sensor.props.height, sensor.props.width
        if kind == IMAGE_COLOR:
            return _np(sensor.color[env.idx]).reshape(h, w * 4)
        if kind == IMAGE_DEPTH:
            return _np(sensor.depth[env.idx])
        if kind == IMAGE_SEGMENTATION:
            return _np(sensor.segmentation[env.idx])
        if kind == IMAGE_OPTICAL_FLOW:
            # (H, W, 2) pixel displacement since the previous frame
            # (graphics.py:225-238's fourth image type): rendered lazily —
            # the first request flips want_flow and re-renders
            if not sensor.want_flow or sensor.flow is None:
                sensor.want_flow = True
                self.render_all_camera_sensors(sim)
            return _np(sensor.flow[env.idx])
        raise ValueError(f"unsupported image type {kind}")

    def get_camera_image_gpu_tensor(self, sim: Sim, env: Env, cam: int, kind: int):
        """Zero-copy image view (interop_torch.py:115-120): a handle whose
        tensor is env `env`'s row of the sensor's image buffer on the device,
        which later renders overwrite in place."""
        sensor = sim.cameras[cam]
        if sensor.color is None:
            self.render_all_camera_sensors(sim)
        buf = {
            IMAGE_COLOR: sensor.color,
            IMAGE_DEPTH: sensor.depth,
            IMAGE_SEGMENTATION: sensor.segmentation,
        }[kind][env.idx]
        return _TensorHandle(sim, f"image:{cam}:{env.idx}:{kind}", buf)

    def start_access_image_tensors(self, sim: Sim):
        self.render_all_camera_sensors(sim)

    def end_access_image_tensors(self, sim: Sim):
        pass

    def write_camera_image_to_file(
        self, sim: Sim, env: Env, cam: int, kind: int, path: str
    ):
        img = self.get_camera_image(sim, env, cam, kind)
        sensor = sim.cameras[cam]
        if kind == IMAGE_COLOR:
            img = img.reshape(sensor.props.height, sensor.props.width, 4)
        _write_image(path, img)

    # -- textures / colors / lights --------------------------------------------
    def create_texture_from_file(self, sim: Sim, path: str) -> int:
        sim.textures.append(_load_texture(path))
        sim._render_changed()
        return len(sim.textures) - 1

    def create_texture_from_buffer(self, sim: Sim, w: int, h: int, data) -> int:
        arr = np.asarray(data, np.uint8).reshape(h, w, 4)
        sim.textures.append(arr)
        sim._render_changed()
        return len(sim.textures) - 1

    def free_texture(self, sim: Sim, tex: int):
        if 0 <= tex < len(sim.textures):
            sim.textures[tex] = None
            sim._render_changed()

    def set_rigid_body_color(self, env: Env, actor: int, body: int, mesh: int, color: Vec3):
        # callable during scene creation (the reference sets colors inline,
        # 1080_balls_of_solitude.py:138): defer until the scene is built
        if env.sim.sim is None:
            env.sim._pending_colors.append(
                (env.idx, actor, body, [color.x, color.y, color.z])
            )
            return
        m = env.sim._meta(actor)
        sh = env.sim.sim.scene.shapes
        mask = sh.body_slot == (m.body_start + body)
        env.sim._shape_color[env.idx, mask] = [color.x, color.y, color.z]
        env.sim._render_changed()

    def get_rigid_body_color(self, env: Env, actor: int, body: int, mesh: int) -> Vec3:
        env.sim._ensure_built()
        m = env.sim._meta(actor)
        sh = env.sim.sim.scene.shapes
        idx = np.nonzero(sh.body_slot == (m.body_start + body))[0]
        if len(idx) == 0:
            return Vec3(0.7, 0.7, 0.7)
        return Vec3(*env.sim._shape_color[env.idx, idx[0]])

    def set_rigid_body_texture(self, env: Env, actor: int, body: int, mesh: int, tex: int):
        """Assign a loaded texture to a body's shapes; the renderer samples
        it with analytic UVs (graphics.py:185-196)."""
        env.sim._ensure_built()
        m = env.sim._meta(actor)
        sh = env.sim.sim.scene.shapes
        mask = sh.body_slot == (m.body_start + body)
        env.sim._shape_tex[env.idx, mask] = tex
        env.sim._render_changed()

    def set_rigid_body_segmentation_id(self, env: Env, actor: int, body: int, seg: int):
        env.sim._ensure_built()
        m = env.sim._meta(actor)
        sh = env.sim.sim.scene.shapes
        mask = sh.body_slot == (m.body_start + body)
        tab = env.sim._render_tables
        seg_arr = np.asarray(tab.seg).copy()
        seg_arr[mask] = seg
        env.sim._render_tables = tab._replace(seg=seg_arr)
        env.sim._render_changed()

    def set_light_parameters(self, sim: Sim, idx: int, color: Vec3, ambient: Vec3, direction: Vec3):
        sim.lights[idx] = (
            np.array([color.x, color.y, color.z]),
            np.array([ambient.x, ambient.y, ambient.z]),
            np.array([direction.x, direction.y, direction.z]),
        )
        sim._render_changed()

    # -- viewer / input / debug draw (headless) --------------------------------
    def create_viewer(self, sim: Sim, props: Optional[CameraProperties] = None) -> Viewer:
        sim.viewer = Viewer(sim, props)
        sim._render_changed()
        return sim.viewer

    def destroy_viewer(self, viewer: Viewer):
        viewer.closed = True

    def query_viewer_has_closed(self, viewer: Viewer) -> bool:
        return viewer.closed

    def viewer_camera_look_at(self, viewer: Viewer, env: Optional[Env], eye: Vec3, target: Vec3):
        from ..render.camera import look_at_quat

        viewer.cam_pos = np.array([eye.x, eye.y, eye.z])
        viewer.cam_quat = look_at_quat(viewer.cam_pos, [target.x, target.y, target.z])

    def get_viewer_camera_transform(self, viewer: Viewer, env: Optional[Env]) -> Transform:
        return Transform(Vec3(*viewer.cam_pos), Quat(*viewer.cam_quat))

    def get_viewer_size(self, viewer: Viewer):
        return type("Size", (), {"x": viewer.props.width, "y": viewer.props.height})()

    def get_viewer_mouse_position(self, viewer: Viewer):
        return type("Pos", (), {"x": viewer.mouse_pos[0], "y": viewer.mouse_pos[1]})()

    def subscribe_viewer_keyboard_event(self, viewer: Viewer, key, action: str):
        viewer.subscriptions[key] = action

    def subscribe_viewer_mouse_event(self, viewer: Viewer, button, action: str):
        viewer.subscriptions[button] = action

    def query_viewer_action_events(self, viewer: Viewer) -> list:
        evs = []
        for name, value in viewer._injected:
            action = viewer.subscriptions.get(name, name)
            evs.append(_ActionEvent(action=action, value=value))
        viewer._injected = []
        return evs

    def draw_viewer(self, viewer: Viewer, sim: Sim, render_collision: bool = True):
        viewer.frames += 1  # offscreen render happens via camera sensors

    def add_lines(self, viewer: Viewer, env: Env, num: int, verts, colors):
        """Store (env, world-frame segments, per-line colors); camera
        renders rasterize them (render/raster.py _ray_lines — reference
        gymutil.draw_lines consumers, test/test01_isaacgym_asset.py:218)."""
        def _un_structured(a):
            a = np.asarray(a)
            if a.dtype.names:  # Vec3/color structured dtype
                a = np.stack([a[n] for n in a.dtype.names[:3]], -1)
            return a.astype(np.float32)

        segs = _un_structured(verts).reshape(-1, 2, 3)
        sim = env.sim
        sim._ensure_built()
        segs = segs + sim._origin(env.idx)  # env -> world
        col = _un_structured(colors).reshape(-1, 3)
        if len(col) < len(segs):
            col = np.broadcast_to(
                col[:1] if len(col) else np.ones((1, 3), np.float32),
                (len(segs), 3),
            )
        viewer.lines.append((env.idx, segs, col[: len(segs)]))
        sim._render_changed()

    def clear_lines(self, viewer: Viewer):
        viewer.lines = []
        viewer.sim._render_changed()

    def draw_env_rigid_contacts(self, viewer: Viewer, env: Env, color, scale, b: bool):
        sim = env.sim
        sim._ensure_built()
        cf = _np(sim.sim.state.contact_force[env.idx])
        pts = _np(sim.sim.state.body_pos[env.idx])
        segs = np.stack([pts, pts + cf * scale], axis=1).astype(np.float32)
        col = np.broadcast_to(
            np.asarray([1.0, 0, 0], np.float32), (len(segs), 3)
        )
        viewer.lines.append((env.idx, segs, col))
        sim._render_changed()

    def draw_env_soft_contacts(self, viewer, env, color, scale, a: bool, b: bool):
        """Line segments along surface-triangle normals scaled by contact
        proximity to the ground plane (the soft analog of
        draw_env_rigid_contacts; reference: soft_body.py stress viz)."""
        sim = env.sim
        sim._ensure_built()
        soft = sim.sim.scene.soft
        if soft is None:
            return
        st = sim.sim.stepper.soft
        soft_pos = sim.sim.state.soft_pos[env.idx : env.idx + 1]
        pos = _np(soft_pos[0])  # (Vt, 3)
        nrm = _np(st.tri_normals(soft_pos))[0]  # (S, 3)
        centers = pos[soft.tris].mean(axis=1)  # (S, 3)
        # contact = triangle center within `thickness + 1 cm` of the plane
        d = centers @ _np(st.plane_n) - st.plane_d - soft.thickness
        mask = d < 0.01
        if not mask.any():
            return
        segs = np.stack(
            [centers[mask], centers[mask] + nrm[mask] * scale], axis=1
        )
        col = (
            np.asarray([color.x, color.y, color.z], np.float32)
            if hasattr(color, "x")
            else np.asarray(color, np.float32)
        )
        col = np.broadcast_to(col.reshape(-1, 3)[:1], (len(segs), 3))
        viewer.lines.append((env.idx, segs.astype(np.float32), col))
        sim._render_changed()


def _prim_opts(o: AssetOptions) -> dict:
    return dict(
        fix_base_link=o.fix_base_link,
        disable_gravity=o.disable_gravity,
        linear_damping=o.linear_damping,
        angular_damping=o.angular_damping,
        max_linear_velocity=o.max_linear_velocity,
        max_angular_velocity=o.max_angular_velocity,
    )


def _load_texture(path: str) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of an image file, read by PIL or imageio. Raises
    where neither is installed (the JAX facade substitutes an 8 x 8 grey
    texture then, and for any file it cannot read)."""
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGBA"))
    try:
        import imageio.v2 as imageio
    except ImportError:
        raise RuntimeError(
            f"create_texture_from_file({path!r}) needs PIL or imageio to read "
            "the file, and neither is installed; create_texture_from_buffer "
            "takes the RGBA bytes instead"
        ) from None
    img = np.asarray(imageio.imread(path))
    if img.ndim == 2:
        img = np.stack([img] * 3 + [np.full_like(img, 255)], -1)
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, img.dtype)], -1
        )
    return img.astype(np.uint8)


def _write_image(path: str, img: np.ndarray):
    try:
        from PIL import Image

        if img.dtype != np.uint8:
            lo, hi = np.nanmin(img[np.isfinite(img)]), np.nanmax(img[np.isfinite(img)])
            img = np.where(np.isfinite(img), img, lo)
            img = ((img - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
        Image.fromarray(img).save(path)
    except Exception:
        np.save(path + ".npy", img)


_GYM_SINGLETON: Optional[Gym] = None


def acquire_gym() -> Gym:
    """The reference's gymapi.acquire_gym() singleton (the reference's
    test/test01_isaacgym_asset.py:104)."""
    global _GYM_SINGLETON
    if _GYM_SINGLETON is None:
        _GYM_SINGLETON = Gym()
    return _GYM_SINGLETON
