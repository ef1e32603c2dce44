"""Synthetic simulation cases, emitted as VoxCad ``.vxc`` text.

These build small self-contained workloads shaped like the reference's three
shipped examples (static TEAM7-style coil over a conducting plate, moving
coil, linear-machine-like multi-phase coils) but with *our own* generated
geometry.  Cases are written as ASCII ``.vxc`` files and loaded through
``read_vxc`` so every test exercises the full input path.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..models.vxc import LETTERS, read_vxc
from ..models.model import Model

__all__ = ["make_vxc_text", "load_case", "case_static", "case_moving",
           "case_lim", "case_convection"]

_HEADER = """<?xml version="1.0" encoding="ISO-8859-1"?>
<VXC Version="0.94">
  <Lattice>
    <Lattice_Dim>{dim}</Lattice_Dim>
    <X_Dim_Adj>1</X_Dim_Adj>
    <Y_Dim_Adj>1</Y_Dim_Adj>
    <Z_Dim_Adj>1</Z_Dim_Adj>
  </Lattice>
  <Palette>
{palette}
  </Palette>
  <Structure Compression="ASCII_READABLE">
    <X_Voxels>{nx}</X_Voxels>
    <Y_Voxels>{ny}</Y_Voxels>
    <Z_Voxels>{nz}</Z_Voxels>
    <Data>
{layers}
    </Data>
  </Structure>
</VXC>
"""

_MATERIAL = """    <Material ID="{ident}">
      <MatType>0</MatType>
      <Name>{name}</Name>
    </Material>"""


def make_vxc_text(shape_xyz, delta0: float, names: list[str], geo_flat: np.ndarray) -> str:
    """Encode a palette + voxel grid as a .vxc document (ASCII structure)."""
    nx, ny, nz = shape_xyz
    geo = np.asarray(geo_flat, np.int64).reshape(nz, ny * nx)
    layers = []
    for z in range(nz):
        chars = "".join("0" if v == 0 else LETTERS[v - 1] for v in geo[z])
        layers.append(f"      <Layer><![CDATA[{chars}]]></Layer>")
    palette = "\n".join(
        _MATERIAL.format(ident=i + 1, name=nm) for i, nm in enumerate(names)
    )
    return _HEADER.format(
        dim=repr(delta0), palette=palette, nx=nx, ny=ny, nz=nz,
        layers="\n".join(layers),
    )


def load_case(text: str) -> Model:
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "in.vxc")
        with open(path, "w") as f:
            f.write(text)
        return read_vxc(path)


def _grid(shape_xyz):
    nx, ny, nz = shape_xyz
    return np.zeros((nz, ny, nx), np.int64)


def _coil_ring(geo, x0, x1, y0, y1, z0, z1, ids):
    """A rectangular coil: X-directed runs on the y0/y1 rows, Y-directed
    runs on the x0/x1 columns.  ids = (axp, axm, ayp, aym) material ids."""
    axp, axm, ayp, aym = ids
    geo[z0:z1, y0, x0 + 1 : x1] = axp         # +x current on near side
    geo[z0:z1, y1, x0 + 1 : x1] = axm         # -x current on far side
    geo[z0:z1, y0 + 1 : y1, x1] = ayp
    geo[z0:z1, y0 + 1 : y1, x0] = aym
    return geo


def case_static(shape_xyz=(20, 20, 12), tol=5e-3, steps=4, dt=1e-3,
                jump=0.0, freq=50.0, sigma=35.26e6) -> str:
    """Static coil over a conducting plate (compare_to_Elmer.vxc-like)."""
    nx, ny, nz = shape_xyz
    geo = _grid(shape_xyz)
    # conducting plate: strictly interior, >=3 cells thick everywhere
    geo[2:7, 3 : ny - 3, 3 : nx - 3] = 1
    _coil_ring(geo, 4, nx - 5, 4, ny - 5, 8, 10, (2, 3, 4, 5))
    amp = f"'1000/(4*dx*2*dz)'"
    names = [
        f"plast D=1 C='mu0*{sigma}'",
        "axp D=1 SRCx=Fp",
        "axm D=1 SRCx=Fm",
        "ayp D=1 SRCy=Fp",
        "aym D=1 SRCy=Fm",
        f"param tran stop={steps * dt} step={dt} jump={jump}",
        f"p2 solver tol={tol} itmax=10000 dir=out",
        f"f1 func Fp=a*cos(p2*f*t) a={amp} p2='2*pi' f={freq} t=t",
        f"f2 func Fm=-a*cos(p2*f*t) a={amp} p2='2*pi' f={freq} t=t",
    ]
    return make_vxc_text(shape_xyz, 0.004, names, geo.ravel())


def case_moving(shape_xyz=(20, 20, 12), tol=5e-3, steps=4, dt=4e-4,
                jump=0.0) -> str:
    """Moving coil over a conducting plate (ec_src_move_hole.vxc-like):
    the coil follows an elliptic path via Vmx/Vmy velocity functions."""
    nx, ny, nz = shape_xyz
    geo = _grid(shape_xyz)
    geo[2:7, 3 : ny - 3, 3 : nx - 3] = 1
    _coil_ring(geo, 6, nx - 7, 6, ny - 7, 8, 10, (2, 3, 4, 5))
    amp = "'500/(4*dx*2*dz)'"
    names = [
        "plast D=1 C='mu0*35.26e6'",
        "axp D=1 SRCx=Fp Vsx=Vmx Vsy=Vmy",
        "axm D=1 SRCx=Fm Vsx=Vmx Vsy=Vmy",
        "ayp D=1 SRCy=Fp Vsx=Vmx Vsy=Vmy",
        "aym D=1 SRCy=Fm Vsx=Vmx Vsy=Vmy",
        f"param tran stop={steps * dt} step={dt} jump={jump}",
        f"p2 solver tol={tol} itmax=10000 dir=out",
        f"f1 func Fp=a*cos(p2*f*t) a={amp} p2='2*pi' f=50 t=t",
        f"f2 func Fm=-a*cos(p2*f*t) a={amp} p2='2*pi' f=50 t=t",
        "m1 func Vmx=a*p2*f*sin(p2*f*t) a='dX*(Nx-14)/2' p2='2*pi' f=25 t=t",
        "m2 func Vmy=a*p2*f*cos(p2*f*t) a='-dY*(Ny-14)/2' p2='2*pi' f=25 t=t",
    ]
    return make_vxc_text(shape_xyz, 0.004, names, geo.ravel())


def case_lim(shape_xyz=(36, 12, 10), tol=5e-3, steps=6, dt=1e-3,
             jump=0.0) -> str:
    """Linear-induction-machine-like case (LIM.vxc-like): three-phase coil
    pairs sliding along x over a conducting bar via a reciprocating Vsx."""
    nx, ny, nz = shape_xyz
    geo = _grid(shape_xyz)
    geo[2:5, 3 : ny - 3, 2 : nx - 2] = 1   # conducting bar
    # six transverse (y-directed) coil slots above the bar
    slots = [(6, 7), (9, 10), (12, 13), (15, 16), (18, 19), (21, 22)]
    for idx, (xa, xb) in enumerate(slots):
        geo[6:8, 3 : ny - 3, xa:xb] = 2 + idx
    amp = "'800/(1*dx*2*dz)'"
    names = [
        "plast D=1 C='mu0*37.26e6'",
        "ap D=1 SRCy=Iap Vsx=Vx",
        "bp D=1 SRCy=Ibp Vsx=Vx",
        "cp D=1 SRCy=Icp Vsx=Vx",
        "am D=1 SRCy=Iam Vsx=Vx",
        "bm D=1 SRCy=Ibm Vsx=Vx",
        "cm D=1 SRCy=Icm Vsx=Vx",
        f"param tran stop={steps * dt} step={dt} jump={jump}",
        f"p2 solver tol={tol} itmax=10000 dir=out",
        f"f1 func Iap=a*cosd(360*f*t) a={amp} f=50 t=t",
        f"f2 func Ibp=a*cosd(360*f*t+120) a={amp} f=50 t=t",
        f"f3 func Icp=a*cosd(360*f*t-120) a={amp} f=50 t=t",
        f"f4 func Iam=-a*cosd(360*f*t) a={amp} f=50 t=t",
        f"f5 func Ibm=-a*cosd(360*f*t+120) a={amp} f=50 t=t",
        f"f6 func Icm=-a*cosd(360*f*t-120) a={amp} f=50 t=t",
        "f7 func Vx=a*impl2(sind(360*f*t)) a='(Nx+10)*dx/time' f='1/time' t=t",
    ]
    return make_vxc_text(shape_xyz, 0.005, names, geo.ravel())


def case_convection(shape_xyz=(24, 12, 10), tol=5e-3, steps=4, dt=1e-3,
                    ve=(3.0, 2.0, 1.0)) -> str:
    """Moving-conductor case: the conducting bar itself has a nonzero
    velocity VEX/VEY/VEZ, so assembly adds the central convection terms
    ±Ve_a/(2Δ_a) to the shared A stencil (EC3D.f90:656-663).  This is the
    one case family where the coded kernels' has_conv branch is live."""
    nx, ny, nz = shape_xyz
    geo = _grid(shape_xyz)
    geo[2:5, 3 : ny - 3, 2 : nx - 2] = 1   # conducting bar (interior, >=3 thick)
    slots = [(6, 7), (10, 11), (14, 15)]
    for idx, (xa, xb) in enumerate(slots):
        geo[6:8, 3 : ny - 3, xa:xb] = 2 + idx
    amp = "'800/(1*dx*2*dz)'"
    vex, vey, vez = ve
    names = [
        f"plast D=1 C='mu0*37.26e6' VEX={vex!r} VEY={vey!r} VEZ={vez!r}",
        "ap D=1 SRCy=Iap",
        "bp D=1 SRCy=Ibp",
        "cp D=1 SRCy=Icp",
        f"param tran stop={steps * dt} step={dt}",
        f"p2 solver tol={tol} itmax=10000 dir=out",
        f"f1 func Iap=a*cosd(360*f*t) a={amp} f=50 t=t",
        f"f2 func Ibp=a*cosd(360*f*t+120) a={amp} f=50 t=t",
        f"f3 func Icp=a*cosd(360*f*t-120) a={amp} f=50 t=t",
    ]
    return make_vxc_text(shape_xyz, 0.005, names, geo.ravel())
