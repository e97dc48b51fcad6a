"""Process and renderer start: RenderFactory.create_render to create_buffer
(the renderer, its scene and settings set, init(), the output buffer)."""


def read(run):
    return run["spans"].get("init_s")
