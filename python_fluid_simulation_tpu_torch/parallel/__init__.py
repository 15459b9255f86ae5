"""Spatial decomposition: meshes of device slots, halo exchanges and the
distributed solves of the sharded step (counterpart of
``python_fluid_simulation_tpu.parallel``; the bucketed particle
residency is not ported)."""
