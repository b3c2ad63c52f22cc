from .cubed_sphere import CubedSphereMesh, build, from_numpy  # noqa: F401
