"""`gymapi` — the reference-compatible API surface on the PyTorch port.

Port of test_isaacgym_tpu/gymapi. Usage mirrors the reference scripts (the
reference's test/test01_isaacgym_asset.py:104-259):

    from test_isaacgym_tpu_torch import gymapi, gymtorch
    gym = gymapi.acquire_gym()
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, sim_params)  # on "cuda:0"
    ...
    root = gymtorch.wrap_tensor(gym.acquire_actor_root_state_tensor(sim))

`create_sim(compute_device, ...)` runs on `cuda:{compute_device}`; pass
`device="cpu"` for the CPU. The acquire_* handles hold tensors on that
device (see facade.py).
"""
from ..core.config import (  # noqa: F401
    AXIS_ALL,
    AXIS_NONE,
    AXIS_ROTATION,
    AXIS_SWING_1,
    AXIS_SWING_2,
    AXIS_TRANSLATION,
    AXIS_TWIST,
    AXIS_X,
    AXIS_Y,
    AXIS_Z,
    SIM_FLEX,
    SIM_PHYSX,
    UP_AXIS_Y,
    UP_AXIS_Z,
    AssetOptions,
    AttractorProperties,
    CameraProperties,
    FlexParams,
    HeightFieldParams,
    PhysXParams,
    PlaneParams,
    SimParams,
    TriangleMeshParams,
    VhacdParams,
)
from ..assets.types import (  # noqa: F401
    DOF_ROTATION,
    DOF_TRANSLATION,
)
from ..render.camera import FOLLOW_POSITION, FOLLOW_TRANSFORM  # noqa: F401
from .facade import (  # noqa: F401
    COMPUTE_PER_FACE,
    COMPUTE_PER_VERTEX,
    DEFAULT_VIEWER_HEIGHT,
    DEFAULT_VIEWER_WIDTH,
    DOF_MODE_EFFORT,
    DOF_MODE_NONE,
    DOF_MODE_POS,
    DOF_MODE_VEL,
    DOMAIN_ACTOR,
    DOMAIN_ENV,
    DOMAIN_SIM,
    ENV_SPACE,
    FROM_ASSET,
    GLOBAL_SPACE,
    IMAGE_COLOR,
    IMAGE_DEPTH,
    IMAGE_OPTICAL_FLOW,
    IMAGE_SEGMENTATION,
    INVALID_HANDLE,
    KEY_ESCAPE,
    KEY_R,
    KEY_SPACE,
    LOCAL_SPACE,
    MESH_COLLISION,
    MESH_VISUAL,
    MESH_VISUAL_AND_COLLISION,
    MOUSE_LEFT_BUTTON,
    RIGID_BODY_DISABLE_GRAVITY,
    RIGID_BODY_DISABLE_SIMULATION,
    RIGID_BODY_NONE,
    STATE_ALL,
    STATE_NONE,
    STATE_POS,
    STATE_VEL,
    Env,
    Gym,
    RigidBodyProperties,
    RigidShapeProperties,
    Sim,
    Viewer,
    acquire_gym,
)
from .mathtypes import (  # noqa: F401
    DofState,
    Quat,
    RigidBodyState,
    Transform,
    Vec3,
    Velocity,
)
