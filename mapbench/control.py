"""The control of the comparison that decides `correct`, at a cell's own
size: for each seed, the inputs a run makes, the reference's SAM of the
sampled pool entries, and the control's (the reference with 8-bit
saturating vector-SW scores put in the program's place); prints how many
sampled entries differ, the number a run compares against its limit 0.
No card is needed; the benchmark's runs do not run this.

    python -m mapbench.control --workload <cell> --seeds <n> [<n> ...]
"""
from __future__ import annotations

import argparse
import json
import time

from mapbench import run
from mapbench.reference import expected_records


def control_reading(workload: str, seed: int) -> dict:
    spec = run.load_cell(workload)
    inp = run.make_inputs(spec["config"], spec["traffic"], seed)
    items = [inp["pool"][i] for i in inp["sample"]]
    t0 = time.perf_counter()
    want = expected_records(spec["config"], spec["traffic"], inp["genome"],
                            items)
    t1 = time.perf_counter()
    got = expected_records(spec["config"], spec["traffic"], inp["genome"],
                           items, control=True)
    return {"workload": workload, "seed": seed, "sampled": len(items),
            "sampled_reads_wrong": sum(a != b for a, b in zip(want, got)),
            "reference_s": t1 - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mapbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    for s in a.seeds:
        print(json.dumps(control_reading(a.workload, s)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
