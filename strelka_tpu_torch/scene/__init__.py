from strelka_tpu_torch.scene.camera import Camera  # noqa: F401
from strelka_tpu_torch.scene.scene import (  # noqa: F401
    AnimationState,
    Curve,
    CurveType,
    Instance,
    InstanceType,
    MaterialDescription,
    Mesh,
    Scene,
    UniformLightDesc,
)
