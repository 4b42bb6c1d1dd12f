"""`entry.write_ms_per_kread`, read the same way, in the cells that hold no
end-to-end rate: there it moves `setup_s`, whose warm-up maps reads
through the same path."""
from mapbench.metrics import load

read = load("entry.write_ms_per_kread").read
