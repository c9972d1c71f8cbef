"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command runs
one cell (a configuration under a traffic mix) on the card and prints one
JSON line.  Everything that measures or judges lives here; from the program
it takes only ``repro_torch.analyze`` and its spans, counters and kernel
names.  See ``portbench/run.py`` for the command."""
