"""Drive loops, one a kind of traffic; a traffic mix's file names its
loop.  A loop module has `Driver(run)` (set-up and warm-up, `unit()`
for one timed unit, `end_to_end`, `unit_work`, `observe`, `release`),
`reference(run, observed)` and `compare(observed, reference)`."""
