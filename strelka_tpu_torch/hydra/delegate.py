"""Hydra-style render delegate — API parity with HdStrelka (layer L5).

The reference ships a USD Hydra plugin (src/HdStrelka/): a RendererPlugin
that constructs a RenderDelegate (RendererPlugin.cpp:17-57), which creates
the render backend and receives a SharedContext through the custom
HdStrelkaDriver token (RenderDelegate.cpp:45-73); a RenderPass bakes the
scene-index prims into oka::Scene on first execute (RenderPass.cpp:360-436)
and per-execute binds the color AOV and calls Render::render
(RenderPass.cpp:439-443).

Without pxr in the environment the delegate fronts our own stage
representation (the parsed usda Prim tree); the SHAPE of the API — plugin ->
delegate(driver ctx) -> render pass -> execute(aov) -> progressive frames —
is preserved so a Hydra-side integration can slot in when pxr exists.

A copy of the JAX package's strelka_tpu/hydra/delegate.py on the port's
TorchRender (RenderType.eTorch; device=None is the card, "cpu" the CPU).
"""

from __future__ import annotations

from typing import Optional

from strelka_tpu_torch import log
from strelka_tpu_torch.loaders.usd import UsdLoader
from strelka_tpu_torch.render.buffer import Buffer, BufferDesc, BufferFormat
from strelka_tpu_torch.render.render import Render, RenderFactory, RenderType
from strelka_tpu_torch.scene.scene import Scene
from strelka_tpu_torch.settings import SharedContext

#: the custom HdDriver token (RenderDelegate.cpp:59-73)
HdStrelkaDriverName = "HdStrelkaDriver"


class StrelkaRenderPass:
    """HdStrelkaRenderPass: one-shot scene bake + per-execute render."""

    def __init__(self, delegate: "StrelkaRenderDelegate"):
        self._delegate = delegate
        self._baked = False

    def execute(self, aov_buffer: Buffer) -> None:
        """_Execute (RenderPass.cpp:292-447): bake once, then render."""
        if not self._baked:
            self._delegate._bake()
            self._baked = True
        self._delegate.render.render(aov_buffer)


class StrelkaRenderDelegate:
    """HdStrelkaRenderDelegate (RenderDelegate.{h,cpp})."""

    SUPPORTED_RPRIM_TYPES = ("Mesh", "BasisCurves")
    SUPPORTED_SPRIM_TYPES = (
        "Camera",
        "Material",
        "RectLight",
        "DiskLight",
        "SphereLight",
        "DistantLight",
    )
    SUPPORTED_BPRIM_TYPES = ("RenderBuffer",)

    def __init__(self, render_type: RenderType = RenderType.eTorch, use_sharding: bool = False, device=None):
        self.render: Render = RenderFactory.create_render(render_type, device=device, use_sharding=use_sharding)
        self.scene = Scene()
        self.render.set_scene(self.scene)
        self._ctx: Optional[SharedContext] = None
        self._stage_path: Optional[str] = None

    # -- driver plumbing (RenderDelegate.cpp:59-73)
    def set_drivers(self, drivers: dict) -> None:
        ctx = drivers.get(HdStrelkaDriverName)
        if ctx is None:
            raise ValueError(f"missing {HdStrelkaDriverName} driver")
        self._ctx = ctx
        self.render.set_shared_context(ctx)
        self.render.init()
        ctx.render = self.render

    # -- render settings descriptors (RenderDelegate.cpp:30-35)
    def get_render_setting_descriptors(self):
        return [
            {"name": "spp", "key": "render/pt/sppTotal", "default": 64},
            {"name": "max bounces", "key": "render/pt/depth", "default": 4},
        ]

    # -- stage population (UsdImagingDelegate.Populate analog)
    def populate_from_usd(self, stage_path: str) -> bool:
        self._stage_path = stage_path
        return True

    def populate_scene(self, scene: Scene) -> None:
        """Directly adopt an already-built Scene (programmatic population)."""
        self.scene = scene
        self.render.set_scene(scene)

    def _bake(self) -> None:
        if self._stage_path is not None and not self.scene.instances:
            if not UsdLoader().load(self._stage_path, self.scene):
                raise RuntimeError(f"failed to load stage {self._stage_path}")
            log.info(
                "Scene bake: {} instances, {} lights, {} materials",
                len(self.scene.instances),
                len(self.scene.lights),
                len(self.scene.materials),
            )

    # -- prim factory surface (RenderDelegate.cpp:123-209)
    def create_render_pass(self) -> StrelkaRenderPass:
        return StrelkaRenderPass(self)

    def create_render_buffer(self, width: int, height: int) -> Buffer:
        return self.render.create_buffer(BufferDesc(width, height, BufferFormat.FLOAT4))

    def get_default_aov_descriptor(self, name: str = "color"):
        return {"format": BufferFormat.FLOAT4, "multiSampled": False}

    # -- material contexts (RenderDelegate.cpp:222-230)
    def get_material_render_contexts(self):
        return ("mtlx", "mdl")

    def get_shader_source_types(self):
        return ("mtlx", "mdl")


class SimpleRenderTask:
    """hdRunner's Hydra task wrapper (SimpleRenderTask.{h,cpp}:12-46):
    Sync/Prepare/Execute delegating to the render pass. The reference keeps a
    3-task ring for in-flight frames; PyTorch's asynchronous CUDA stream
    covers that, so one task per AOV binding suffices."""

    def __init__(self, render_pass: StrelkaRenderPass, aov_buffer):
        self._pass = render_pass
        self._aov = aov_buffer

    def sync(self) -> None:  # HdTask::Sync
        pass

    def prepare(self) -> None:  # HdTask::Prepare
        pass

    def execute(self) -> None:  # HdTask::Execute -> RenderPass::_Execute
        self._pass.execute(self._aov)


class StrelkaRendererPlugin:
    """HdStrelkaRendererPlugin (RendererPlugin.cpp:12-57)."""

    @staticmethod
    def is_supported() -> bool:
        return True

    @staticmethod
    def create_render_delegate(**kwargs) -> StrelkaRenderDelegate:
        return StrelkaRenderDelegate(**kwargs)
