"""Optional pxr (OpenUSD) integration — used when `import pxr` succeeds.

The reference is a C++ Hydra plugin registered with the pxr plugin system
(`src/HdStrelka/RendererPlugin.cpp:12-15`, plugInfo.json) and
opens stages with full composition via UsdStage::Open
(`src/hdRunner/main.cpp:566-591`). This environment has no
pxr, so the framework ships its own usda/usdc parsers (flattened-stage
subset). This module makes the pxr claim FALSIFIABLE instead of structural:
when a real pxr is importable,

  * `open_stage_flattened(path)` opens the stage with pxr — full LIVRPS
    composition (sublayers, inherits, variants, references, payloads,
    specializes) — flattens it, and feeds the flattened usda TEXT through
    this framework's own parser, so every downstream capability (materials,
    lights, instancing, curves) is exercised identically either way;
  * `register()` exposes the delegate under the reference's renderer-plugin
    id so a Hydra-side host can look it up.

Without pxr every entry point degrades gracefully (returns None/False); the
pure-Python parser path in loaders/usd.py remains the default.
"""

from __future__ import annotations

from typing import Optional

from strelka_tpu_torch import log

#: the reference plugin id (HdStrelka plugInfo.json)
PLUGIN_ID = "HdStrelkaRendererPlugin"

_REGISTRY: dict = {}


def pxr_available() -> bool:
    try:
        import pxr  # noqa: F401

        return True
    except ImportError:
        return False


def open_stage_flattened(path: str) -> Optional[str]:
    """Open `path` with pxr, flatten the composed stage, return usda text.

    Returns None when pxr is unavailable or the stage fails to open. The
    text parses with loaders/usda_parser (pxr's flattened export is plain
    usda), giving the framework full USD composition whenever pxr exists."""
    if not pxr_available():
        return None
    from pxr import Usd

    stage = Usd.Stage.Open(path)
    if stage is None:
        log.error("pxr failed to open stage {}", path)
        return None
    flat = stage.Flatten()
    return flat.ExportToString()


def load_with_pxr(path: str, scene) -> bool:
    """UsdLoader.load via pxr composition (None-op without pxr -> False)."""
    text = open_stage_flattened(path)
    if text is None:
        return False
    import os
    import tempfile

    from strelka_tpu_torch.loaders.usd import UsdLoader

    # the flattened layer is self-contained except asset paths, which pxr
    # resolves to absolute on export; write next to nothing in particular
    with tempfile.NamedTemporaryFile(
        "w", suffix=".usda", dir=os.path.dirname(os.path.abspath(path)), delete=False
    ) as f:
        f.write(text)
        tmp = f.name
    try:
        return UsdLoader().load(tmp, scene)
    finally:
        os.unlink(tmp)


def register() -> bool:
    """Register the renderer plugin under the reference's plugin id.

    With pxr present this also asks pxr's plugin registry for any installed
    HdStrelka C++ plugin (the reference's build artifact) and logs which
    implementation (native plugin vs this framework) serves the id."""
    from strelka_tpu_torch.hydra.delegate import StrelkaRendererPlugin

    _REGISTRY[PLUGIN_ID] = StrelkaRendererPlugin
    if pxr_available():
        try:
            from pxr import Plug

            native = Plug.Registry().GetPluginWithName("HdStrelka")
            if native is not None:
                log.info("pxr has a native HdStrelka plugin at {}", native.path)
        except Exception as e:  # noqa: BLE001 — registry probing is best-effort
            log.warning("pxr plugin registry probe failed: {}", e)
    return True


def get_renderer_plugin(plugin_id: str = PLUGIN_ID):
    """Plugin lookup (HdRendererPluginRegistry::GetRendererPlugin analog)."""
    if plugin_id not in _REGISTRY:
        register()
    return _REGISTRY.get(plugin_id)
