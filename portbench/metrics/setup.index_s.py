"""Index: the harness's clock around build_index (seconds)."""


def read(ctx):
    return ctx["setup"].get("index_s")
