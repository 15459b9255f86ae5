"""Spatial decomposition: meshes of device slots, halo exchanges and the
distributed solves of the sharded step, and bucketed particle residency
on 1D slab meshes (counterpart of ``python_fluid_simulation_tpu.parallel``;
the (x, z) residency of its ``particles2d.py`` is not ported)."""
