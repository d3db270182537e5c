"""scene_compile_s: host seconds of the port's compile of the cell's scenes
in set-up (``build_scene``, or the env's constructor that calls it)."""


def read(ctx):
    return ctx["setup"].get("scene_compile_s")
