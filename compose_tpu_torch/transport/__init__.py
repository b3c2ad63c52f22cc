from . import cdr_fused, dss, gallery, isl, limiter, spf, timeint  # noqa: F401
from .isl import IslConfig, IslTransport  # noqa: F401
