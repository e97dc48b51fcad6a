from strelka_tpu_torch.hydra.delegate import (  # noqa: F401
    HdStrelkaDriverName,
    SimpleRenderTask,
    StrelkaRenderDelegate,
    StrelkaRendererPlugin,
    StrelkaRenderPass,
)
