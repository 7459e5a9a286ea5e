"""Per-layer metric readers, one a file: `read(window)` takes a
`tracing.TraceWindow` and returns the metric in its unit, or None where
the window holds nothing to read.  A metric `<base>.<suffix>` without a
file of its own is read by `<base>.py`.  `COUNTERS` names the program's
counters a reader needs, as {key: (module, attribute)}."""
