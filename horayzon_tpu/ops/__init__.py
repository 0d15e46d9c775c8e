# Copyright (c) 2026
# MIT License
"""Compute core: shifted-slice sweeps, max-mip pyramids, refraction."""

from horayzon_tpu.ops import mip
from horayzon_tpu.ops import sweep
from horayzon_tpu.ops import refraction
from horayzon_tpu.ops import locations
from horayzon_tpu.ops import multires
from horayzon_tpu.ops import shadow_scan
