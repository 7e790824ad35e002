"""Per-layer metric readers, one file each, named as the metric is
(`<name>.py`, loaded by path): each defines `read(run)`, which returns
the metric's value for the window, or None when the run holds nothing
for it to read.  `run` is `cookbench.run.WindowRun`."""
