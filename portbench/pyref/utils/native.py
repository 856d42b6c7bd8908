"""No native library: every caller takes its pure-Python path."""


def get_lib():
    return None
