from . import local_qp, quadrature, reduce, sphere, sqr  # noqa: F401
