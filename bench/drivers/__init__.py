"""General drivers, one per kind of traffic; each reads its mix's
parameters and runs the program's own entry points."""
