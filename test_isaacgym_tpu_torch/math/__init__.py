from . import quat, spatial, transform  # noqa: F401
from .quat import (  # noqa: F401
    matrix_to_quat,
    orientation_error,
    quat_conjugate,
    quat_exp_map,
    quat_from_angle_axis,
    quat_from_euler_zyx,
    quat_identity,
    quat_integrate,
    quat_inverse,
    quat_log_map,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inverse,
    quat_to_angle_axis,
    quat_to_euler_zyx,
    quat_to_matrix,
)
from .transform import (  # noqa: F401
    transform_apply,
    transform_identity,
    transform_inverse,
    transform_mul,
    transform_vector,
)
