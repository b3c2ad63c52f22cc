"""NetCDF output of nodal fields (compose_tpu.io): the continuous-node
coordinates and per-step CGLL fields in a NetCDF3 file written by scipy's
`netcdf_file`, with the JAX package's variables and layout: an unlimited
`time` dimension first, `node`, the f64 variables `lat`, `lon` (node),
`time` (time) and one (time, node) variable per field."""

from scipy.io import netcdf_file

from .config import F64
from .ops import sphere
from .transport import dss


def _host(x):
    return x.detach().to(device="cpu", dtype=F64).numpy()


class NetcdfWriter:
    """add_nodal_field while defining, then advance_time_to and
    write_field per output time; close at the end."""

    def __init__(self, mesh, path):
        self.mesh = mesh
        self.f = netcdf_file(path, "w")
        # scipy's NetCDF3 writer needs the unlimited dimension first.
        self.f.createDimension("time", None)
        self.f.createDimension("node", mesh.cnn)
        lat, lon = sphere.xyz2ll(mesh.cgll_xyz.to(F64))
        for name, data in (("lat", lat), ("lon", lon)):
            self.f.createVariable(name, "d", ("node",))[:] = _host(data)
        self.tvar = self.f.createVariable("time", "d", ("time",))
        self.vars = {}
        self.nt = 0
        self._defined = False

    def add_nodal_field(self, name):
        if self._defined:
            raise RuntimeError("add_nodal_field after end_definition")
        self.vars[name] = self.f.createVariable(name, "d", ("time", "node"))

    def end_definition(self):
        self._defined = True

    def advance_time_to(self, t):
        self.tvar[self.nt] = t
        self.nt += 1

    def write_field(self, name, dgll_data, dgbfi):
        """dgll_data: (ncell, np2), averaged with the weights dgbfi onto
        the continuous nodes (dss.d2c) and written at the current time."""
        m = self.mesh
        cg = dss.d2c(dgll_data.reshape(-1).to(F64), m.c2d_idx, m.c2d_mask,
                     dgbfi.reshape(-1).to(F64))
        self.vars[name][self.nt - 1, :] = _host(cg)

    def close(self):
        self.f.close()
