"""Spatial decomposition: meshes of device slots (on one card or over
several), the placements, halo exchanges and the distributed solves of
the sharded step, and bucketed particle residency on 1D slab meshes and
(x, z) meshes (counterpart of ``python_fluid_simulation_tpu.parallel``,
all of it)."""
