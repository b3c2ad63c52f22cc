from . import qlt, tree  # noqa: F401
