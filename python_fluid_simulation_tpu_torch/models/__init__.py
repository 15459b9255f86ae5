"""The learned viscosity operator: the 3D U-Net (and its `FastUnpool`),
its feature box, the trainer (the masked MSE, Adam / AdamW steps, the
engine's training pairs) and the capture -> train -> eval pipeline
(counterpart of ``python_fluid_simulation_tpu.models``)."""
