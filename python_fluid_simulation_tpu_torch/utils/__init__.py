"""Host-side utilities of the port: metrics, checkpoints, IO, timers, the roofline model and the HTML viewer."""
