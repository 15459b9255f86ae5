"""The learned viscosity operator: the 3D U-Net, its feature box and the
capture of training pairs (counterpart of ``python_fluid_simulation_tpu.
models``)."""
