from fourdgs_torch.geometry.se3 import (  # noqa: F401
    skew,
    so3_exp,
    so3_log,
    se3_V,
    se3_exp,
    se3_apply,
    update_pose,
)
from fourdgs_torch.geometry.projection import (  # noqa: F401
    projection_matrix,
    world_to_view,
    full_projection,
    fov2focal,
    focal2fov,
    backproject_depth,
)
from fourdgs_torch.geometry.quaternion import (  # noqa: F401
    quat_normalize,
    quat_to_rotmat,
    quat_multiply,
    rotmat_to_quat,
)
from fourdgs_torch.geometry.sh import SH_C0, sh0_to_rgb, rgb_to_sh0  # noqa: F401
