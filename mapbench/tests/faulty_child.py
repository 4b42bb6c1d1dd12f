"""`mapbench.child` with the port's SAM stream broken underneath, for
the tests that see `correct` come out false. MAPBENCH_TEST_FAULT names
the fault: `drop_half` leaves out the records of every odd read (half
the batch); `alter` moves the position of every seventh read by one
where the stream produces it; `repeat` hands back the previous batch's
SAM again (a step that returns its state unchanged)."""
import os
import sys

from mapbench import child


def _broken(stream):
    fault = os.environ["MAPBENCH_TEST_FAULT"]

    def gen(*a, **kw):
        it = stream(*a, **kw)
        if it is None:
            return None
        return _apply(it, fault)
    return gen


def _apply(it, fault):
    prev = None
    for chunk in it:
        if fault == "repeat":
            out, prev = (prev if prev is not None else chunk), chunk
            yield out
            continue
        lines = []
        for line in chunk.split(b"\n")[:-1]:
            f = line.split(b"\t")
            n = int(f[0])
            if fault == "drop_half" and n % 2:
                continue
            if fault == "alter" and n % 7 == 0 and f[3] != b"0":
                f[3] = b"%d" % (int(f[3]) + 1)
            lines.append(b"\t".join(f))
        yield b"".join(x + b"\n" for x in lines)


def main(argv):
    from shrimp_tpu_torch import fastpath, fastpath_cs
    fastpath.map_unpaired_sam_stream = _broken(
        fastpath.map_unpaired_sam_stream)
    fastpath_cs.map_unpaired_cs_sam_stream = _broken(
        fastpath_cs.map_unpaired_cs_sam_stream)
    return child.main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
