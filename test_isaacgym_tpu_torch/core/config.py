"""Parameter objects mirroring the reference's config surface
(SimParams/PlaneParams/AssetOptions/CameraProperties/AttractorProperties —
SURVEY.md §5.6; field inventory from the reference's test/test01_isaacgym_asset.py:107-130
and examples/franka_cube_ik_osc.py:111-126).

These are host-side dataclasses; the scene builder bakes them into device
tensors at finalize time. A copy of test_isaacgym_tpu/core/config.py;
TriangleMeshParams and HeightFieldParams default their `transform` to the
facade's gymapi.Transform.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# up-axis enums (gymapi.UP_AXIS_*)
UP_AXIS_Y = 0
UP_AXIS_Z = 1

# engine selection retained for CLI parity; both run the same pipeline
SIM_PHYSX = 0
SIM_FLEX = 1


@dataclasses.dataclass
class PhysXParams:
    solver_type: int = 1
    num_position_iterations: int = 4
    num_velocity_iterations: int = 1
    num_threads: int = 0
    use_gpu: bool = True
    contact_offset: float = 0.01
    rest_offset: float = 0.0
    friction_offset_threshold: float = 0.04
    friction_correlation_distance: float = 0.025
    bounce_threshold_velocity: float = 0.2
    # cap on the Baumgarte penetration-recovery velocity (PhysX parity:
    # effectively unbounded by default). Scenes that enable cross-step
    # contact warm starting should LOWER this (~0.5 m/s): the velocity-level
    # Jacobi solver injects the bias into real momentum, and a converged
    # warm impulse plus an unbounded bias turns deep contacts into
    # launch-and-bounce limit cycles.
    max_depenetration_velocity: float = 100.0
    # CROSS-STEP contact warm starting: persist the solver's accumulated
    # impulses in SimState and re-apply them next step (within-step warm
    # starting across substeps is always on). Helps quasi-static scenes at
    # low iteration counts (uniform stacks settle at 4 iterations that
    # jitter cold); hurts impact-heavy / extreme-mass-ratio scenes, where
    # the split-mass Jacobi un-learns a stale impact impulse as slowly as
    # it learned it. Off by default.
    warm_start_contacts: bool = False
    # solver penetration allowance before the Baumgarte bias pushes back
    # (added to rest_offset). The 1.5 mm default is the grasp-compliance
    # tuning (force-limited fingers sink in ~1mm to squeeze,
    # franka_cube_ik_osc.py:365); tight-tolerance scenes (SDF nut-bolt
    # threads, feature size < 1mm) must set it well below the feature size.
    contact_slop: float = 1.5e-3
    # SDF contact pair directions. True (default): for a mesh pair where
    # both sides carry SDFs, probe in BOTH directions (a's surface samples
    # vs b's field AND b's vs a's) — the richer manifold gripper-driven
    # screwing needs (single-direction loses the franka_nut_bolt
    # friction-turn). False: keep only directions whose
    # target field has a closed form, evaluated inline with zero grid
    # gathers — the fast path for kinematically driven thread contact
    # (envs/nut_bolt.py), where the probe sampling alone captures the
    # manifold (validated by the descent-rate=pitch tests).
    sdf_bidirectional: bool = True


@dataclasses.dataclass
class FlexParams:
    solver_type: int = 5
    num_outer_iterations: int = 4
    num_inner_iterations: int = 15
    relaxation: float = 0.75
    warm_start: float = 0.4
    shape_collision_margin: float = 0.0
    dynamic_friction: float = 0.0
    static_friction: float = 0.0


@dataclasses.dataclass
class SimParams:
    dt: float = 1.0 / 60.0
    substeps: int = 2
    up_axis: int = UP_AXIS_Z
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.8)
    use_gpu_pipeline: bool = True
    stress_visualization: bool = False
    stress_visualization_min: float = 0.0
    stress_visualization_max: float = 1e5
    num_client_threads: int = 0
    physx: PhysXParams = dataclasses.field(default_factory=PhysXParams)
    flex: FlexParams = dataclasses.field(default_factory=FlexParams)


@dataclasses.dataclass
class PlaneParams:
    normal: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    distance: float = 0.0
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0
    segmentation_id: int = 0


@dataclasses.dataclass
class VhacdParams:
    resolution: int = 100000
    max_convex_hulls: int = 64
    max_num_vertices_per_ch: int = 64
    concavity: float = 0.0025


@dataclasses.dataclass
class AssetOptions:
    fix_base_link: bool = False
    armature: float = 0.0
    disable_gravity: bool = False
    flip_visual_attachments: bool = False
    collapse_fixed_joints: bool = False
    use_mesh_materials: bool = False
    mesh_normal_mode: int = 0  # COMPUTE_PER_VERTEX
    thickness: float = 0.0
    density: float = 1000.0
    linear_damping: float = 0.0
    # isaacgym's AssetOptions default (its docs/bindings): 0.5 — this is
    # what brings free-rolling bodies to rest (ideal rolling has no slip
    # for Coulomb friction to act on)
    angular_damping: float = 0.5
    max_linear_velocity: float = 1000.0
    max_angular_velocity: float = 64.0
    enable_gyroscopic_forces: bool = True
    override_inertia: bool = False
    override_com: bool = False
    vhacd_enabled: bool = False
    vhacd_params: VhacdParams = dataclasses.field(default_factory=VhacdParams)
    default_dof_drive_mode: int = 0
    slices_per_cylinder: int = 20
    convex_decomposition_from_submeshes: bool = False
    replace_cylinder_with_capsule: bool = False
    tendon_limit_stiffness: float = 1.0
    use_physx_armature: bool = True
    min_particle_mass: float = 1e-12


@dataclasses.dataclass
class CameraProperties:
    width: int = 1280
    height: int = 720
    horizontal_fov: float = 90.0  # degrees
    near_plane: float = 0.01
    far_plane: float = 1000.0
    supersampling_horizontal: int = 1
    supersampling_vertical: int = 1
    use_collision_geometry: bool = False
    enable_tensors: bool = False


# attractor axis flags (gymapi.AXIS_*)
AXIS_NONE = 0
AXIS_X = 1
AXIS_Y = 2
AXIS_Z = 4
AXIS_TRANSLATION = 7
AXIS_SWING_1 = 8
AXIS_SWING_2 = 16
AXIS_TWIST = 32
AXIS_ROTATION = 56
AXIS_ALL = 63


@dataclasses.dataclass
class AttractorProperties:
    stiffness: float = 0.0
    damping: float = 0.0
    forceLimit: float = np.inf
    axes: int = AXIS_ALL
    rigid_handle: int = -1
    target: Optional[object] = None  # Transform
    offset: Optional[object] = None  # Transform


@dataclasses.dataclass
class TriangleMeshParams:
    nb_vertices: int = 0
    nb_triangles: int = 0
    transform: Optional[object] = None
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0

    def __post_init__(self):
        if self.transform is None:
            from ..gymapi.mathtypes import Transform

            self.transform = Transform()


@dataclasses.dataclass
class HeightFieldParams:
    """gym.add_heightfield parameter block."""

    nbRows: int = 0
    nbColumns: int = 0
    column_scale: float = 1.0
    row_scale: float = 1.0
    vertical_scale: float = 1.0
    transform: Optional[object] = None
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0

    def __post_init__(self):
        if self.transform is None:
            from ..gymapi.mathtypes import Transform

            self.transform = Transform()
