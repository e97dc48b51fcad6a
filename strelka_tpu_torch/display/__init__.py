from strelka_tpu_torch.display.display import (  # noqa: F401
    Display,
    DisplayFactory,
    HeadlessDisplay,
    InputHandler,
    MatplotlibDisplay,
    ResizeHandler,
)


def __getattr__(name):  # lazy: web server module only when asked for
    if name == "WebDisplay":
        from strelka_tpu_torch.display.web import WebDisplay

        return WebDisplay
    raise AttributeError(name)
