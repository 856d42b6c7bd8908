"""Device front tables: the harness's clock around DeviceFront(...),
the cuckoo build and the upload (seconds)."""


def read(ctx):
    return ctx["setup"].get("front_s")
