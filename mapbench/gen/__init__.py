"""Input generators, found by the name that a configuration's `genome`
or a traffic mix's `generator` gives: `mapbench/gen/<name>.py`, each
with `make(params, rng)`."""
