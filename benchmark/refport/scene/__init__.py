from refport.scene.camera import Camera  # noqa: F401
from refport.scene.scene import (  # noqa: F401
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
