"""Operation and byte counts the benchmark divides by measured times:
the chip's peaks, the whole step's floor and the PCG kernels' counts.
Frozen here so that no later change of the program moves the yardstick;
nothing here imports the program."""
