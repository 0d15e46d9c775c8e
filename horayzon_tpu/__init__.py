# Copyright (c) 2026
# MIT License
"""HORAYZON-TPU: terrain horizon, sky-view-factor and shadow maps in JAX.

A from-scratch JAX/XLA framework with the capabilities of
ChristianSteger/HORAYZON (terrain horizon, sky view factor, visible sky
fraction, topographic openness, slope, shadow maps and shortwave-radiation
correction factors from high-resolution digital elevation models), compiled
by XLA for the attached accelerator (an NVIDIA GPU in production):

* Ray casting against an Embree BVH (reference: horizon_comp.cpp:79-292) is
  replaced by a gather-free *shifted-slice sweep* over a device-resident
  heightfield with a conservative max-mip pyramid for the far field.
* TBB shared-memory parallelism (reference: horizon_comp.cpp:739-800) is
  replaced by data-parallel array operations plus ``shard_map`` over a
  device mesh.
* The forward computation is differentiable w.r.t. the DEM elevation.

Submodule layout mirrors the reference package (horayzon/__init__.py:1-12) so
users can migrate by renaming imports; the compute core lives in ``ops``
(sweeps), ``parallel`` (meshes/sharding), ``models`` (high-level pipelines)
and ``utils`` (host-side IO and timing helpers).  The package name keeps the
project's historical name.
"""

from horayzon_tpu import auxiliary
from horayzon_tpu import direction
from horayzon_tpu import domain
from horayzon_tpu import download
from horayzon_tpu import geoid
from horayzon_tpu import horizon
from horayzon_tpu import load_dem
from horayzon_tpu import ocean_masking
from horayzon_tpu import shadow
from horayzon_tpu import topo_param
from horayzon_tpu import transform
from horayzon_tpu import sun_position
from horayzon_tpu import terrain
from horayzon_tpu import regrid
from horayzon_tpu import ops
from horayzon_tpu import parallel
from horayzon_tpu import models
from horayzon_tpu import utils

__version__ = "0.1.0"
